"""Drive the PyTorch/CUDA port (``apex_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (a non-zero exit, and no result line):

1. build   — compile the CUDA kernels under ``apex_tpu_torch/csrc``
             (one ``nvcc`` per source, all at once) and print the card's
             name and power limit as ``nvidia-smi`` reports them.
2. kernels — hold each hand-written kernel against its plain PyTorch
             version on the card, at the serving and training paths'
             shapes, in bf16 and fp32; print each one's error, time,
             bound and the time of a PyTorch library call for the same
             function, if any; the layer norm (csrc/layer_norm.cu) at
             hidden 1024: the forward at 4, 512, 2304 and 8192 rows, the
             backward and its fold at 2304 and 8192 (bf16 layer norm and
             RMSNorm, fp32 input), dscale and dbias equal to the plain
             version's, under 0.1% of a bf16 dx more than one ulp off, the
             same bits twice, and ragged and wide hiddens beside; a
             short-vs-mid reading at s in {256, 384,
             512}, the flash kernels at b=2 h=8 s=4096 (and a reading at
             s=8192), the decode kernel's fused q-RoPE, and a mid-vs-flash
             reading at s in {1024, 2048, 4096}; the dequant-matmul
             kernels (int8 and int4 weights, block 128) at the decode
             shape (m=4) of each flagship projection, fc1 at m=512 and
             qkv and fc2 at m=2304 (with one k split and with several,
             in both kernels), beside torch.matmul on the dense bf16
             weight; the decode kernel over int8 pages at
             877 and 4 x 2300 cached tokens, beside bf16 pages; the decode
             op's many-row instance at a chunk's shape (1 slot, h=8, C=256
             rows at start 256 over 512 cached tokens) and its tree
             instance at offramp_tree(4) (R=9) and chain_tree(4) (R=5)
             over 4 slots of 877 tokens, bf16, fp32, int8 pages and rope,
             and the many-row instance at the decode step's 1 and 4 rows
             beside the small kernel that serves them; the decode
             kernels' span split (each sequence's positions in spans of
             fixed absolute positions, one block each, merged in span
             order by the last block: span, spans, grid and workspace
             bytes logged, a 512-row chunk's among them): every entry at
             lengths on the span edges beside an idle slot in a pool
             whose pages_per_seq runs far past them, bf16/fp32, int8
             pages, rope, causal or not, the tree mask, d = 64 and 128,
             pages of 16 and 64, NaN on the null page, held against the
             plain version and the plain model of the spans, the same
             bits twice; and serve-long's decode layout (4 x 2300) with
             and without rope, held and timed; the softmax kernel at (8, 8, 1024, 1024), causal and with a
             padding mask, beside torch.softmax on the pre-scaled input;
             the seven segment-id variants (BERT's key padding, packed
             documents, and fmha's padding, whose fully masked query rows
             must give out 0 and dq 0) at h=16 d=64: the short rung at
             b=16 s=512, the mid rung at b=8 s=1024, the flash rung at b=2
             s=4096, fp32 and bf16, beside SDPA with the boolean mask;
             last, every bf16 instance of the three forwards (the
             wgmma/TMA kernel of attention_fwd_sm90.cuh, d=64 and 128,
             ids x dropout x bias) at ragged shapes (sq = sk = 1000,
             causal 700 x 1100; 500 and 300 x 470 on the short rung)
             with a row that sees no key and rows the bias hides,
             against the plain versions and for the same bits twice;
             then every bf16 instance of the short and mid backwards
             (the wgmma/TMA kernels of attention_bwd_sm90.cuh, d=64 and
             128, ids x dropout x bias, and the dBias instances) at the
             short and mid ones of those shapes, with a real lse
             cotangent on the mid rung, fed the plain forward's out and
             lse: dq, dk, dv within two bf16 ulps of the plain backward,
             dBias within its band, the same bits twice.  Phase 1 prints
             each such instance's registers and spills.  The Gumbel-max
             sampler (Triton) at 4 x 32768 and 20 x 32768, T 0.7 and 1,
             without a floor and with top-k 40 + top-p 0.9, 64 ctx
             values: tokens equal to the plain version's wherever its top
             two ``y + g`` differ by more than 8 ulps (the rest counted,
             at most 0.1%), the same bits twice.  The optimizer tail's
             four multi-tensor kernels (csrc/multi_tensor.cu) at the
             flagship's 148 tensors at O5 and on edge lists (a zero-size
             tensor, odd lengths, mixed dtypes, a tensor off the 16-byte
             grid, 600 tensors, one tensor of 4,101 chunks): scale and its
             axpby instance and Adam (with the unscale folded in, a bf16
             second moment, without masters) equal to the plain version
             bit for bit, Adam with a clip and LAMB within 2 ulps plus
             1e-5 of each value's step, the norms within 1e-5 and the same
             bits twice; an inf at the first or the last element skips
             Adam and LAMB bit for bit; each timed beside its plain
             version, its bound and torch._fused_adamw_ /
             torch._foreach_norm / torch._foreach_mul_.
3. parity  — the flagship GPT's width at 2 layers, fp32 compute: the
             paged greedy tokens of ``ContinuousBatcher`` (6 ragged
             requests, 2 slots, 16 new tokens) must equal the port's
             full-recompute ``generate_reference`` token for token, and
             so must a 600-token prompt's (prefill on the mid rung); then
             the same for the Llama-mode GPT (rope, RMSNorm, SwiGLU) with
             prompts up to 2500 tokens (prefill on the flash rung, decode
             through the fused q-RoPE).
   quant-parity — the same 2-layer fp32 flagship served from int8 and
             int4 weight pools, and the Llama mode from int4: paged
             greedy == ``generate_reference`` on the same pools, both
             through the dequant kernels; then int8 KV pages (fp32
             weights): every request completes, and their decode logits
             must stay within 2% of the logit scale of full-precision
             pages, with argmax agreeing at 98% of positions or more.
   chunked-parity — the 2-layer fp32 flagship and Llama mode, prompts
             that share prefixes: chunked, prefix-cached paged greedy ==
             ``generate_reference``; a prefix hit's logits bit-identical
             to a cold admission's; chain (n-gram drafts) and tree
             (offramp_tree(4), an int4 ``ModelDraftSource``) speculation
             == plain greedy; int8 KV chunked completes, its logits
             within quant-parity's band of fp32 pages.
   sample-parity — the 2-layer fp32 flagship and Llama mode sampling at
             T=0.8, top-k 40, top-p 0.95 on seeded requests: two
             admission orders on 2 and 3 slots, chunked + prefix-cached
             prefill, chain (n-gram drafts, and drafts of the stream
             itself) and tree (offramp_tree(4)) speculation all commit
             the plain sampled stream; the GPU's stream equals the
             port's CPU stream (a first divergence only where the CPU's
             top-two margin is under 1e-4 of the logit scale); the
             replayed decode and verify steps give the eager steps'
             tokens, greedy and sampled, with equal launch counts.
4. serve   — the full flagship GPT (12 layers, bf16): 8 requests with
             prompts of 32..512 tokens, 32 greedy tokens each, through
             ``decode_fns`` + ``ContinuousBatcher`` (the decode step
             replayed as a CUDA graph), then one 900-token prompt
             (prefill padded to 960), then the 8 requests again through
             the eager decode step and sampled (replayed and eager);
             every request must complete, and every serving kernel must
             have launched in this phase; the bf16 logits are printed
             beside the same weights at fp32.
5. profile — the same model under ``torch.profiler``: four prefills,
             then one harvest window of decode steps, replayed and
             eager; the device's busy share and the kernels that took its
             time.
   serve-quant — the same model and requests served from weights
             {bf16 copies made once, int8, int4} x KV pages {bf16, int8}:
             decode ms/step replayed and eager, ms per prefill, the
             weight bytes a step streams and the rate that implies, the
             KV pool's bytes, and the int8/int4 logits against bf16
             weights, and the int4 / int8-KV run sampled; every request
             must complete and the three new kernels must launch; a
             decode window profiled with the bf16 copies and at int4
             weights with int8 KV.
   serve-chunked — the same model on the JAX bench's mixed load: 7
             short 8-token prompts and 4 long ones (a shared 512-token
             prefix + 8-token tails) on 8 slots, after one priming
             request, monolithic vs chunked (C=256) vs chunked with the
             prefix cache: decode ms/step, prefill stalls, TTFT, prefix
             hits; the many-row instance must launch.
   serve-spec — the same model, 4 slots of 32-token repetitive prompts,
             16 new tokens, k=4: plain vs n-gram chain vs offramp_tree(4)
             from the int4 ``ModelDraftSource``, each greedy replayed,
             greedy eager and sampled: tokens committed per verify step,
             ms per committed token, share equal to plain.
   fused-softmax — ``FusedScaleMaskSoftmax`` (padding mask and causal)
             forward and backward at (8, 8, 1024, 1024) bf16 through the
             softmax kernel, against its plain version.
   serve-long — the 12-layer Llama-mode GPT in bf16: four requests of
             64..2300 prompt tokens (prefill padded to 2304, the flash
             rung), 32 greedy tokens each, decode with the fused q-RoPE;
             then phase 5's profile of it (prompts of 2300 tokens), and
             the same four requests from int8 weights and int8 KV pages
             (the dequant kernels at m=2304 in prefill), and one
             2300-token prompt in 256-token chunks (rope in the many-row
             instance).
   serve-fp16-parity — (fp16 serving, O1-O3; phase 2 also holds and
             times the fp16 instances of the paged decode and of the
             dequant pair at their bf16 rows' shapes, the dequant's fp16
             results under 1% a ulp off the plain version and none more)
             2 layers at the flagship's width at O2: paged greedy ==
             recompute on the same fp16, int8 and int4 weights,
             monolithic, chunked + prefix-cached, chain and tree
             speculative (a first divergence only under a top-two margin
             of 1% of the logit scale); a prefix hit's fp16 logits
             bit-identical to cold; int8 KV within quant-parity's band of
             fp16 pages; the replayed decode and verify steps equal the
             eager ones bit for bit (tokens, the K/V pools past the null
             page, launches); the GPU's greedy and sampled streams against
             the CPU's (hidden 256).
   serve-fp16 — the 12-layer flagship at O2: phase 4's requests replayed
             and eager (ms/step beside phase 4's bf16), int8 weights, int8
             KV, a chunked prefix-cached run, an offramp_tree(4) run from
             the int4 draft model, a sampled run, the fp16-vs-fp32 logit
             band; the Llama mode at O2 on a 2300-token prompt; every
             fp16 serving instance must launch.
6. train-parity — one step of loss, backward and FusedAdam on the GPU
             (kernels) against a CPU copy of the same model and state
             (plain versions), fp32, 2 layers at the flagship's width:
             the flagship at s=384 (short rung) and s=640 (mid rung), the
             Llama mode at s=2560 (flash rung): loss, every grad and the
             updated parameters must agree.
7. train   — the full flagship at O5, 8 x 1024 tokens, remat on, through
             the port trainer's step: 2 warm-up and 10 timed steps; the
             loss must be finite and fall, and the mid kernels and
             multi_tensor_adam must have launched.  Prints ms/step,
             tokens/s, MFU, peak memory, the launches and the step-1 loss
             at O5 against fp32; then the same with ``--fused-opt-tail``
             (train-fused-tail).
8. profile — one training step under ``torch.profiler`` (after each run
             of phase 7), with the host ms inside the optimizer step and
             the device ms of the multi-tensor kernels.
   train-amp — the flagship trainer with ``amp.initialize("O5",
             loss_scale="dynamic")``, per-leaf and fused tail fed the same
             gradients: 3 steps equal bit for bit; an inf injected in the
             backward leaves parameters, masters, moments and the step
             counter unchanged bit for bit and halves the scale, the next
             step proceeds, a StepGuard sees both; both tails under
             ``torch.cuda.set_sync_debug_mode("error")``; step_scaled (the
             unscale folded into the kernel) equal to the per-leaf tail;
             then FusedMixedPrecisionLamb through step_scaled for 3 steps
             (the norm and LAMB kernels' path).
9. train-long — the 12-layer Llama-mode GPT at O5, 2 x 4096 tokens, as
             ``gpt_pretrain --position-embedding rope --activation swiglu
             --normalization rmsnorm --seq 4096 --micro-batch 2
             --num-micro 1`` trains it, the same measurements as phase 7,
             the flash kernels required; then one step profiled.
10. bert-parity — BERT at BERT-large's widths, 2 layers, fp32, b=2 x 512
             ragged: one step (loss, backward, FusedAdam) on the GPU
             against a CPU copy; attention_impl short/mid/pallas agree on
             the card; ``contrib.fmha`` on the GPU equals its CPU path.
11. bert-train — BERT-large (24 layers) at O4, b=16 x 512 with lengths in
             128..512, 15% MLM and binary labels: 2 warm-up and 10 timed
             steps; the loss must be finite and fall and the short rung's
             segment kernels must launch; ms/step, real and padded
             tokens/s, MFU, peak memory, then one step profiled by kernel.
12. bert-finetune — ``examples/bert_finetune`` at its default model size,
             200 steps at batch 16: the held-out accuracy must rise from
             chance to 0.8 or more.
13. fmha-varlen — ``FMHA`` at BERT-large's head widths, 8 packed
             sequences of 64..512 tokens, forward and backward at max_s
             512, 1024 and 4096 (the short, mid and flash segment
             instances, all of which must launch), held in fp32 against
             each sequence's plain attention alone.

Dropout (after phase 9; phase 2 also holds the hidden-dropout kernel at
8 x 1024 x 1024, bit for bit, and the dropout instances of all seven
attention kernels and the short pair's segment instances at their rows'
shapes, then reads each rung's mask exactly with q = 0 and V = I):
   train-dropout-parity — phase 6 at s=384 and 640 with hidden and
             attention dropout 0.1 and one key on both devices: loss,
             grads and updated parameters must agree, the dropout
             instances and the dropout kernel must launch.
   train-dropout — the 12-layer flagship at O5, 8 x 1024, dropout
             0.1/0.1, ``GPTModel.loss(rng=fold_in(base, step))`` ->
             backward -> FusedAdam: 2 warm-up and 10 timed steps, then
             one profiled; the loss must be finite and end below its
             start, the step-1 loss within 0.02 of fp32's.
   train-long-dropout — the same for the Llama mode at 2 x 4096, 3
             timed steps: the flash dropout instances must launch.
   seg-dropout — ``flash_attention`` with segment ids and dropout at
             BERT-large's shape, forward and backward: the short rung's
             segment dropout instances must launch.

Contrib attention (after seg-dropout; phase 2 also holds the additive-bias
instances of all seven attention kernels, per-head, per-batch and shared,
fp32 and bf16, the short ones at the decoder's shape of mha-train, against
their plain versions; rows the bias alone hides must read as the uniform
mean of V):
   mha-parity — ``SelfMultiheadAttn`` and ``EncdecMultiheadAttn`` at embed
             128, fp32, with every option (bias, norm-add, boolean and
             float masks, padding, causal, dropout with a key): GPU ==
             CPU, output and every gradient, and fast == default.
   mha-train — Transformer-big's widths (embed 1024, 16 heads) at O4,
             bias, norm-add, dropout 0.1, 32 x 256 padded tokens: the
             encoder's and the decoder's (future mask) self-attention,
             encoder-decoder attention over 320 source tokens, and the
             decoder's without padding or dropout; ms per
             forward+backward, tokens/s, peak memory, launches; each
             attention context within two bf16 ulps of impl='default''s.
   mha-rungs — the module on the mid rung (8 x 1024, per-head bias) and
             the flash rung (2 x 4096, per-batch bias), fp32, against its
             plain attention on the card.

A trainable bias (after mha-rungs; phase 2 also holds the dBias instances
of the short/mid and flash dQ kernels against their plain versions, fp32
and bf16, causal, with (1, h, sq, sk), per-batch, per-head and shared
biases, a causal sq < sk case a rung and rows the bias alone hides, and
times dbias-train's four beside the bias instance without dBias and SDPA
with a float mask that requires grad):
   dbias-train — q, k, v and an ``nn.Parameter`` bias trained through
             ``flash_attention`` for 5 FusedAdam steps against a random
             target, O4, causal: Transformer-big's decoder (b=32 h=16
             s=256 d=64, a (1, h, s, s) bias; alone and with mha-train's
             padding ids and dropout 0.1), the flagship's attention (b=8
             h=8 s=1024 d=128, a shared (s, s) bias), the Llama mode's
             (b=2 h=8 s=4096 d=128, (1, h, s, s)): ms per
             forward+backward, peak memory, a falling loss, step 1's dBias
             against the plain backward on the card; then one
             forward+backward a rung at b=2 h=4 s=300, fp32, GPU == CPU
             (output, dq, dk, dv, dBias).

The fp16 levels O1-O3 (after train-long; phase 2 also builds the fp16
attention instances from their own sources, holds every one against its
plain version at the forward's and the backward's ragged cases, times
each fp16 row at its bf16 row's shape beside the bf16 instance and SDPA
in fp16, holds and times the fp16 hidden dropout bit for bit, the fp16
layer norm with fp32 weights (O2) and fp16 weights (O3), the softmax in
fp16 and Adam over the flagship's O2 list):
   train-fp16-parity — a 2-layer GPT (hidden 512, 4 heads of 128, 2 x
             384 tokens) through the port trainer at O1, O2 and O3 with
             the dynamic loss scaler, 4 steps on the GPU and on a CPU copy
             from the same weights and batches: step 1's loss, every
             gradient and the updated parameters within fp16 bands; the
             same steps skipped on both, the third (an inf in its
             backward) skipped with the parameters unchanged bit for bit
             and the scale halved, the fourth taken; then one O2 step
             each, GPU against CPU, of the GPT with dropout 0.1/0.1 on
             one key, BERT with padding (segment ids) and contrib
             ``SelfMultiheadAttn`` with a float mask (and the key padding
             and dropout beside it).
   train-fp16 — the 12-layer flagship at O2 (fp16 parameters, fp32
             norms and masters, dynamic scaling), 8 x 1024, through
             ``gpt_pretrain --opt-level O2``: phase 7's measurements and
             every skipped step, beside phase 7's O5 in this run; the mid
             pair's fp16 instances must launch; then one step profiled.
   train-long-fp16 — the 12-layer Llama mode at O2, 2 x 4096 (the flash
             rung's fp16 instances), full depth.
   train-long-fp16-skips — the same Llama run, 12 steps: before each,
             the same backward with the flash rung's plain versions in
             place of its kernels (on the card, from the same state); the
             kernels must skip exactly the steps the plain versions
             overflow on, and a skipped step's non-finite gradients are
             named.
   fp16-variants — ``flash_attention`` in fp16 on each rung (short s=384,
             mid s=768, flash s=1280, the rung forced), causal, with
             segment ids, dropout and a constant or trained bias, every
             combination, GPU against CPU: every fp16 instance must
             launch.

The fused cross entropy, T5 and ResNet (after fmha-varlen; no new
kernel: T5 runs rows 1, 2 and 7, the fused CE's chunk products are
cuBLAS's and ResNet's convolutions cuDNN's):
   fused-ce-parity — the fused chunked LM-head cross entropy, fp32, 2 x
             512 tokens of hidden 1024 at vocab 32768 (chunk 8192) and
             30522 with a bias and smoothing 0.1 (chunk 5087): equal to
             the two-step path on the card and to the fused path on the
             CPU (loss, dx, dW, dbias); the bf16 band at the flagship's
             width (8 x 1024 tokens); each path's forward + backward
             timed at 8 x 1024 and 24 x 1024 tokens with its peak.
   train-fused-ce — the flagship trainer at O5, 8 x 1024 and 24 x 1024,
             ``fused_ce`` True and False: ms/step, tokens/s, peak memory
             (the card's crossover); at 24 x 1024 ``fused_ce=None`` must
             take the fused path, whose peak must be below the two-step
             path's.
   bert-train-fused-ce — bert-train's BERT-large step with
             ``fused_ce=True`` (chunks of 5087), not profiled.
   t5-parity — T5 at bench.py's widths (hidden 512, 8 heads, vocab
             32768), 2 + 2 layers: one step GPU vs CPU at fp32 (256 + 256
             tokens; 384 encoder + 200 decoder, cross attention at sq !=
             sk), then at O5 within bf16 bands; the encoder's cross
             weights get zero gradients.
   t5-train — bench.py's ``_t5_extra``: 6 + 6 layers, 16 x 512 + 512,
             bf16, FusedAdam with masters: ms/step, tokens/s, MFU, peak
             memory, a falling loss; short_fwd, short_bwd, ln_fwd and
             ln_bwd must launch; one step profiled.
   resnet-parity — ResNet-50 at 2 x 64x64 and ResNet-18 at 2 x 32x32,
             fp32: one step GPU vs CPU (logits, running statistics,
             gradients, updated parameters), then eval mode.
   rn50-train — bench.py's RN50: 64 x 224x224, O5, FusedAdam: images/s,
             ms/step, MFU from the convolutions' FLOPs, peak memory; one
             step profiled; then a few steps of
             ``examples/imagenet_amp`` and its prec@1 / prec@5.

The last two lines are a JSON object with one record per kernel (the
fp16 instances' names end in ``_f16``), and ``{"ok": true, "device":
{...}}``.  The script imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
import types

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and the
# operation rates of the types these kernels compute in
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float16: 989e12,
                  torch.float32: 67e12}
#: the 16-bit element types of the Hopper attention kernels: bf16 (O4/O5)
#: and fp16 (O1-O3, the ``_f16`` sources); phase 2 holds and times each
#: row in both, side by side
SM90_DTYPES = (torch.bfloat16, torch.float16)

# the flagship GPT (bench.py FLAGSHIP): vocab 32768, 12 layers, hidden
# 1024, 8 heads (head_dim 128), ffn 4096, learned positions up to 1024
FLAGSHIP = dict(vocab_size=32768, num_layers=12, hidden_size=1024,
                num_attention_heads=8, ffn_hidden_size=4096,
                max_position_embeddings=1024)
# the Llama-mode GPT at the same widths (the JAX trainer's defaults with
# --position-embedding rope --activation swiglu --normalization rmsnorm):
# no position table, three SwiGLU matrices of 4096
LLAMA = dict(vocab_size=32768, num_layers=12, hidden_size=1024,
             num_attention_heads=8, ffn_hidden_size=4096,
             position_embedding="rope", activation="swiglu",
             normalization="rmsnorm")
LONG_SEQ = 4096         # its training length, past the mid rung's 2048
#: the layer norm's kernels on every training path: the forward, the
#: backward and its column-sum fold
LN_TRAIN = ("ln_fwd", "ln_bwd", "ln_bwd_fold")


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at magnitude ``x`` (8 significant
    bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126))) - 7)


def fp16_ulp(x: float) -> float:
    """The spacing of fp16 values at magnitude ``x`` (11 significant
    bits; 2**-24 among the subnormals)."""
    return 2.0 ** (max(math.floor(math.log2(max(abs(x), 2.0 ** -24))),
                       -14) - 10)


def elem_ulp(x: float, dtype) -> float:
    """The spacing of ``dtype``'s values (bf16 or fp16) at ``x``."""
    return fp16_ulp(x) if dtype == torch.float16 else bf16_ulp(x)


def dtype_name(dtype) -> str:
    return str(dtype)[6:]


def f16(name: str, dtype) -> str:
    """A launch counter of ``dtype``'s instance: ``_f16`` last for fp16."""
    return name + "_f16" if dtype == torch.float16 else name


def short_name(dtype) -> str:
    """``bf16``, ``fp16`` or ``fp32``: a record's shape names its type."""
    return {torch.bfloat16: "bf16", torch.float16: "fp16"}.get(dtype,
                                                                "fp32")



def tolerance(ref: torch.Tensor) -> float:
    """Kernel-vs-plain tolerance on the same inputs.  fp32: 1e-4 of the
    output's scale (both compute in fp32; only the order of the sums
    differs).  bf16 and fp16: two ulps of the type at the output's largest
    magnitude (both round fp32 values to the type, which may fall on
    either side of a rounding boundary; the tensor-core kernels also
    round the probabilities, dz * scale and, on the flash rung, q * scale
    to the type before their products, where the plain versions of the
    forward keep fp32)."""
    top = ref.float().abs().max().item()
    if ref.dtype == torch.float32:
        return 1e-4 * max(1.0, top)
    return 2.0 * elem_ulp(top, ref.dtype)


def _events_ms(run, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters: int = 50) -> tuple:
    """``(device_ms, eager_ms)`` of one call, from CUDA events after a
    warm-up.  ``device_ms`` replays ``iters`` calls captured in one CUDA
    graph, so it is the device's time without the host's launch cost;
    ``eager_ms`` issues the calls from Python as the serving loop does,
    so for a small kernel it is the host's launch rate."""
    def loop():
        for _ in range(iters):
            fn()            # results dropped: one output buffer in use

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    eager = _events_ms(loop, iters)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        loop()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(graph.replay, iters), eager


def bound_ms(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def check(name: str, got, want, what: str) -> float:
    err = max_err(got, want)
    tol = tolerance(want)
    if not math.isfinite(err) or err > tol:
        fail(f"{name} {what}: max |kernel - plain| = {err:.3g} > "
             f"tolerance {tol:.3g}")
    log(f"  {name} {what}: max_abs_err {err:.3g} (tolerance {tol:.3g})")
    return err


def measure(name, shape, err, kernel, plain, library, *, nbytes, ops,
            dtype, plain_iters: int = 50) -> dict:
    """Time a kernel, its plain version (over ``plain_iters`` calls) and
    (``(label, fn)`` or None) the PyTorch call that computes the same
    function; the bound is the larger of ``nbytes`` over the memory rate
    and ``ops`` over the peak rate of ``dtype``."""
    ms, eager = time_ms(kernel)
    if dtype == torch.float16:
        # the fp16 rows' plain versions repeat their bf16 rows' (no
        # yardstick of speed): two calls a timing
        plain_iters = 2
    plain_ms, _ = time_ms(plain, plain_iters)
    lib_ms = time_ms(library[1])[0] if library else None
    bnd, by = bound_ms(nbytes, ops, dtype)
    lib_txt = f"{library[0]} {lib_ms:.4f} ms" if library else "no library call"
    log(f"  {name} {shape}: {ms:.4f} ms on the device ({eager:.4f} ms per "
        f"eager call), plain {plain_ms:.4f} ms, {lib_txt}, bound "
        f"{bnd:.5f} ms ({by})")
    return dict(shape=shape, max_abs_err=err, ms=ms, eager_ms=eager,
                plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                library_ms=lib_ms)


# ---------------------------------------------------------------- phase 1
#: the Hopper kernels' template arguments in a mangled name: the forward
#: (attention_fwd_sm90.cuh) <D, NC, SEGS, DROP, BIAS, QSCALE>, the
#: backward's (attention_bwd_sm90.cuh) dK/dV <D, NC, SEGS, DROP, BIAS> and
#: dQ <D, NC, SEGS, DROP, BIAS, DBIAS>
_SM90_TYPE = r"(13__nv_bfloat16|6__half)"
_SM90_KERNELS = (
    ("forward",
     re.compile(r"fwd_kernelI" + _SM90_TYPE + r"Li(\d+)ELi(\d)E"
                + r"Lb(\d)E" * 4),
     ("+seg", "+drop", "+bias", " q*scale first"), "rows"),
    ("dK/dV",
     re.compile(r"bwd_dkv_kernelI" + _SM90_TYPE + r"Li(\d+)ELi(\d)E"
                + r"Lb(\d)E" * 3),
     ("+seg", "+drop", "+bias"), "keys"),
    ("dQ",
     re.compile(r"bwd_dq_kernelI" + _SM90_TYPE + r"Li(\d+)ELi(\d)E"
                + r"Lb(\d)E" * 4),
     ("+seg", "+drop", "+bias", "+dbias"), "rows"),
)


def sm90_instances(text: str) -> dict:
    """``{instance: (registers, spill-store bytes)}`` of the Hopper
    kernels (the forward's ``fwd_kernel<T, D, NC, SEGS, DROP, BIAS,
    QSCALE>``, the backward's ``bwd_dkv_kernel<T, D, NC, SEGS, DROP,
    BIAS>`` and ``bwd_dq_kernel<T, D, NC, SEGS, DROP, BIAS, DBIAS>``, T
    bf16 or fp16) from ``nvcc -Xptxas -v`` output."""
    found, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = None
            for kind, pattern, names, tile in _SM90_KERNELS:
                t = pattern.search(m.group(1))
                if not (t and "sm90" in m.group(1)):
                    continue
                ty, d, nc, *on = t.groups()
                d, nc, on = int(d), int(nc), [int(x) for x in on]
                ty = "bf16" if ty.endswith("bfloat16") else "fp16"
                flags = "".join(f for f, x in zip(names, on) if x)
                plain = "" if any(on[:3]) else " plain"
                current = (f"{ty} {kind} d={d} {tile}={64 * nc}{plain}"
                           f"{flags}")
                found[current] = (0, 0)
                break
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            found[current] = (found[current][0], int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found[current] = (int(m.group(1)), found[current][1])
    return found


#: the dequant kernels' template arguments in a mangled name: the decode
#: kernel <T, MT, INT4>, the wgmma kernel <T, N, INT4>, the tiled one <T,
#: INT4>
_DEQUANT_KERNELS = re.compile(
    r"dequant_(decode|wgmma|tiled)I(13__nv_bfloat16|6__half|f)"
    r"(?:Li(\d+)E)?Lb(\d)E")


def dequant_instances(text: str) -> dict:
    """``{instance: (registers, spill-store bytes)}`` of the dequant
    kernels (``dequant_decode<T, MT, INT4>``, ``dequant_wgmma<T, N,
    INT4>``, ``dequant_tiled<T, INT4>``) from ``nvcc -Xptxas -v``
    output."""
    found, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = None
            t = _DEQUANT_KERNELS.search(m.group(1))
            if t:
                kind, dtype, num, int4 = t.groups()
                x = (" bf16 x" if dtype.endswith("bfloat16") else
                     " fp16 x" if dtype.endswith("half") else " fp32 x")
                current = (f"dequant_{kind}{x}"
                           + (f" {num}-token tiles" if num and
                              kind == "wgmma" else "")
                           + (f" {num} rows" if num and kind == "decode"
                              else "")
                           + (" int4" if int4 == "1" else " int8"))
                found[current] = (0, 0)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            found[current] = (found[current][0], int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found[current] = (int(m.group(1)), found[current][1])
    return found


def phase_build() -> str:
    from apex_tpu_torch.ops import common

    t0 = time.perf_counter()
    logs = common.build()
    log(f"[build] {len(logs)} CUDA sources compiled in "
        f"{time.perf_counter() - t0:.1f} s: {sorted(logs)}")
    # one nvcc a source, all started together: each one's end, from the
    # start (the fp16 attention instances build in the _f16 sources)
    log("  each source's compile ended at: " + ", ".join(
        f"{n} {t:.1f} s" for n, t in sorted(common.BUILD_SECONDS.items(),
                                            key=lambda x: x[1])))
    # the -Xptxas -v report, summed per source: a kernel that spills or
    # needs more registers than its launch bounds allow shows here
    for name, text in sorted(logs.items()):
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(m) for m in
                     re.findall(r"(\d+) bytes spill stores", text))
        log(f"  {name}: {len(regs)} kernels, {min(regs, default=0)}-"
            f"{max(regs, default=0)} registers a thread, {spills} bytes "
            "of spill stores")
        for inst, (nregs, nspill) in sm90_instances(text).items():
            log(f"    {name} {inst}: {nregs} registers, "
                f"{nspill} bytes of spill stores")
        for inst, (nregs, nspill) in dequant_instances(text).items():
            log(f"    {name} {inst}: {nregs} registers, "
                f"{nspill} bytes of spill stores")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    return card


# ---------------------------------------------------------------- phase 2
def phase_kernels(dev) -> dict:
    from apex_tpu_torch.ops import attention_short as short
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        x = torch.randn(*shape, generator=gen, device=dev) * scale + shift
        return x.to(dtype)

    records = {}
    hidden = FLAGSHIP["hidden_size"]
    heads = FLAGSHIP["num_attention_heads"]
    d = hidden // heads

    records.update(timed("kernels: layer_norm_kernels", layer_norm_kernels,
                         randn, dev))

    # -- short prefill attention: b=1, h=8, causal ----------------------
    log("[kernels] short_fwd (CUDA), b=1 h=8 d=128 causal")
    for dtype in (torch.float32,) + SM90_DTYPES:
        for s in (512, 100):
            q, k, v = (randn(1, heads, s, d, dtype=dtype) for _ in range(3))
            got = short.short_fwd(q, k, v, causal=True)
            want = short._short_fwd_plain(q, k, v, True, d ** -0.5)
            err = check("short_fwd", got[0], want[0],
                        f"{str(dtype)[6:]} s={s} out")
            lse_err = max_err(got[1], want[1])
            if not lse_err <= 1e-3:
                fail(f"short_fwd {dtype} s={s} lse: error {lse_err:.3g} "
                     "> 1e-3")
            log(f"  short_fwd {str(dtype)[6:]} s={s} lse: max_abs_err "
                f"{lse_err:.3g} (tolerance 1e-3)")
            if dtype not in SM90_DTYPES or s != 512:
                continue
            pairs = heads * s * (s + 1) / 2           # causal (q, k) pairs
            records[f16("short_fwd", dtype)] = [measure(
                f16("short_fwd", dtype),
                f"b=1 h={heads} s={s} d={d} causal {dtype_name(dtype)}", err,
                lambda: short.short_fwd(q, k, v, causal=True),
                lambda: short._short_fwd_plain(q, k, v, True, d ** -0.5),
                ("SDPA", lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True)),
                nbytes=4 * q.numel() * q.element_size() + heads * s * 4,
                ops=4.0 * d * pairs, dtype=dtype)]

    # each part's wall: the script must end within 1200 s, and aims at
    # half of that
    part = lambda fn, *args: timed(f"kernels: {fn.__name__}", fn, *args)
    records.update(part(attention_train_kernels, randn))

    records.update(part(decode_kernels, randn, dev))
    records.update(part(flash_kernels, randn))
    part(crossover_long, randn)
    records.update(part(dequant_kernels, randn))
    records.update(part(decode_int8_kernels, randn, dev))
    records.update(part(decode_rows_kernels, randn, dev))
    for name, recs in part(decode_split_kernels, randn, dev).items():
        records[name].extend(recs)
    records.update(part(softmax_kernels, randn))
    records.update(part(segment_kernels, randn))
    records.update(part(dropout_kernels, randn))
    records.update(part(gumbel_kernels, randn, dev))
    records.update(part(bias_kernels, randn))
    records.update(part(dbias_kernels, randn))
    records.update(part(optimizer_kernels, randn, dev))
    part(fwd_sm90_kernels, randn, dev)
    part(bwd_sm90_kernels, randn, dev)
    # each fp16 row beside its bf16 row, timed in this call at one shape
    for name in sorted(records):
        if name.endswith("_f16") and name[:-4] in records:
            rec, bf = records[name][0], records[name[:-4]][0]
            rec["bf16_ms"] = bf["ms"]
            log(f"  {name}: {rec['ms']:.4f} ms, {rec['ms'] / bf['ms']:.3f}x "
                f"the bf16 instance ({bf['ms']:.4f} ms) at {rec['shape']}")
    return records


#: the layer norm's rows at hidden 1024: a decode step's 4 slots, a
#: 512-token prefill, serve-long's 2304-token prefill, a training step's
#: 8 x 1024 tokens; the backward at the last two
LN_ROWS = (4, 512, 2304, 8192)
LN_BWD_ROWS = (2304, 8192)
#: (label, x dtype, rms): the O5 norms (bf16 x, fp32 parameters), the
#: final norm's fp32 input (``_final_norm``) and O2's (fp16 x, fp32
#: parameters)
LN_CASES = (("layer norm bf16", torch.bfloat16, False),
            ("RMSNorm bf16", torch.bfloat16, True),
            ("layer norm fp32 x", torch.float32, False),
            ("layer norm fp16 (O2)", torch.float16, False))
#: other instances, held but not timed: (rows, hidden, x dtype, parameter
#: dtype, rms): ragged hiddens (the scalar instances), rows past one
#: register chunk (read again each pass), bf16 and fp16 parameters
LN_PROBES = ((37, 72, torch.bfloat16, torch.bfloat16, False),
             (301, 1000, torch.float32, torch.bfloat16, False),
             (9, 3000, torch.bfloat16, torch.float32, True),
             (66, 4100, torch.float16, torch.float16, False),
             (5, 1024, torch.float16, torch.float32, True),
             (8192, 1024, torch.float16, torch.float16, False),
             (3, 8192, torch.bfloat16, torch.bfloat16, False))
#: the share of a bf16 dx's elements that may lie more than one bf16 ulp
#: (at the element's own magnitude) off the plain version: the kernel's
#: fp32 row sums c1, c2 are added in another order, which moves dx by
#: ~1e-7 of the row's scale, over one ulp only where dx nearly cancels
LN_FLIP_LIMIT = 1e-3


def ulp_flips(got, want) -> float:
    """The share of elements of a bf16 (or fp16) result more than one ulp
    of the plain version's value off it."""
    w = want.float()
    bits = 8 if want.dtype == torch.bfloat16 else 11
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126)))
                     - (bits - 1))
    return ((got.float() - w).abs() > ulp).float().mean().item()


def ln_bwd_check(name, got, want, what) -> float:
    """Hold ``(dx, dscale, dbias)`` of the backward kernels against the
    plain version: dx to the tolerance (and a 16-bit dx to the ulp share),
    the column sums to the same values, since the plain version adds them
    in the kernels' order."""
    err = check(name, got[0], want[0], f"{what} dx")
    if want[0].dtype != torch.float32:
        flips = ulp_flips(got[0], want[0])
        if not flips <= LN_FLIP_LIMIT:
            fail(f"{name} {what}: {flips:.3%} of dx more than one ulp off "
                 f"the plain version (limit {LN_FLIP_LIMIT:.1%})")
        log(f"  {name} {what}: {flips:.4%} of dx more than one ulp off "
            f"(limit {LN_FLIP_LIMIT:.1%})")
    for label, g, w in (("dscale", got[1], want[1]),
                        ("dbias", got[2], want[2])):
        if w is None:
            continue
        if not torch.equal(g, w):
            off = (g != w).sum().item()
            fail(f"{name} {what} {label}: {off} of {w.numel()} column sums "
                 f"differ from the plain version's (max "
                 f"{max_err(g, w):.3g}), which adds in the kernels' order")
        log(f"  {name} {what} {label}: equal to the plain version's")
    return err


def same_bits(name, a, b, what) -> None:
    for x, y in zip(a, b):
        if x is not None and not torch.equal(x, y):
            fail(f"{name} {what}: two runs on the same inputs differ")


def layer_norm_kernels(randn, dev) -> dict:
    """``ln_fwd`` at ``LN_ROWS`` x ``LN_CASES`` and ``ln_bwd`` with
    ``ln_bwd_fold`` at ``LN_BWD_ROWS`` x ``LN_CASES``, hidden 1024, against
    their plain versions, the same bits on two runs; then ``LN_PROBES``.
    Times every case: the forward beside ``F.layer_norm`` / ``F.rms_norm``
    on the input (parameters in its dtype), the backward beside the same
    call forward+backward through autograd (profiled) and its backward
    alone, the fold alone beside ``torch.sum`` over the partials."""
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops.common import stream_of
    import torch.nn.functional as F

    hidden = FLAGSHIP["hidden_size"]
    log(f"[kernels] ln_fwd, ln_bwd, ln_bwd_fold (CUDA), hidden {hidden}")
    w = randn(hidden, scale=0.1, shift=1.0)
    b = randn(hidden, scale=0.1)
    records = {"ln_fwd": [], "ln_bwd": [], "ln_bwd_fold": []}

    def library(x, rms, wl, bl):
        if rms:
            return lambda: F.rms_norm(x, (hidden,), wl, 1e-5)
        return lambda: F.layer_norm(x, (hidden,), wl, bl, 1e-5)

    for rows in LN_ROWS:
        for label, dtype, rms in LN_CASES:
            bias = None if rms else b
            what = f"{label} rows={rows}"
            x = randn(rows, hidden, dtype=dtype, scale=3.0, shift=0.5)
            got = ln.layer_norm_fwd(x, w, bias, 1e-5, rms)
            want = ln._ln_fwd_plain(x, w, bias, 1e-5, rms)
            err = check("ln_fwd", got[0], want[0], f"{what} y")
            check("ln_fwd", got[1], want[1], f"{what} mean")
            check("ln_fwd", got[2], want[2], f"{what} invvar")
            same_bits("ln_fwd", got, ln.layer_norm_fwd(x, w, bias, 1e-5, rms),
                      what)
            wl, bl = w.to(dtype), b.to(dtype)
            numel = x.numel() * x.element_size()
            records["ln_fwd"].append(measure(
                "ln_fwd", f"rows={rows} hidden={hidden} {label}", err,
                lambda: ln.layer_norm_fwd(x, w, bias, 1e-5, rms),
                lambda: ln._ln_fwd_plain(x, w, bias, 1e-5, rms),
                ("F.rms_norm" if rms else "F.layer_norm",
                 library(x, rms, wl, bl)),
                nbytes=2 * numel + (1 if rms else 2) * hidden * 4
                + 2 * rows * 4, ops=8.0 * x.numel(), dtype=torch.float32))
            if rows not in LN_BWD_ROWS:
                continue
            dy = randn(rows, hidden, dtype=dtype)
            _, mean, invvar = want
            bdt = None if rms else b.dtype
            got = ln.layer_norm_bwd(dy, x, w, bdt, mean, invvar, rms)
            want = ln._ln_bwd_plain(dy, x, w, bdt, mean, invvar, rms)
            err = ln_bwd_check("ln_bwd", got, want, what)
            same_bits("ln_bwd", got,
                      ln.layer_norm_bwd(dy, x, w, bdt, mean, invvar, rms),
                      what)
            xg, wg, bg = (t.detach().clone().requires_grad_()
                          for t in (x, wl, bl))
            leaves = (xg, wg) if rms else (xg, wg, bg)
            call = library(xg, rms, wg, bg)

            def lib_fwd_bwd():
                torch.autograd.grad(call(), leaves, dy)

            fb_ms = profiled_ms(lib_fwd_bwd)
            with torch.no_grad():
                f_ms = profiled_ms(call)
            rec = measure(
                "ln_bwd", f"rows={rows} hidden={hidden} {label}", err,
                lambda: ln.layer_norm_bwd(dy, x, w, bdt, mean, invvar, rms),
                lambda: ln._ln_bwd_plain(dy, x, w, bdt, mean, invvar, rms),
                None, nbytes=3 * numel + hidden * 4 * (2 if rms else 4)
                + 2 * rows * 4, ops=20.0 * x.numel(), dtype=torch.float32)
            rec["library_ms"] = fb_ms
            rec["library_bwd_ms"] = fb_ms - f_ms
            log(f"  ln_bwd: library call is "
                f"{'F.rms_norm' if rms else 'F.layer_norm'} forward+backward "
                f"({fb_ms:.4f} ms), its backward alone (library_bwd_ms) "
                f"{fb_ms - f_ms:.4f} ms")
            # the result line takes a kernel's first record: the backward's
            # and the fold's at the training step's rows, bf16 layer norm
            main = rows == LN_BWD_ROWS[-1] and dtype == torch.bfloat16
            records["ln_bwd"].insert(0 if main and not rms else
                                     len(records["ln_bwd"]), rec)
            if dtype != torch.bfloat16 or rms:
                continue
            # the fold alone, on this shape's partials
            plan = ln.layer_norm_plan(rows, hidden, dtype, w.dtype)
            partials = randn(2, plan.blocks, hidden)
            out = [torch.empty(hidden, device=dev) for _ in range(2)]
            fold = lambda: ln._fold_cuda(partials, *out, plan.blocks, hidden,
                                         stream_of(partials))
            fold()
            want = ln._fold_plain(partials)
            if not (torch.equal(out[0], want[0])
                    and torch.equal(out[1], want[1])):
                fail(f"ln_bwd_fold {what}: the sums differ from the plain "
                     "version's (the same adds in the same order)")
            log(f"  ln_bwd_fold {what} ({plan.blocks} partials a column): "
                "equal to the plain version's")
            records["ln_bwd_fold"].insert(
                0 if main else len(records["ln_bwd_fold"]), measure(
                "ln_bwd_fold", f"blocks={plan.blocks} hidden={hidden} "
                "fp32", 0.0, fold, lambda: ln._fold_plain(partials),
                ("torch.sum", lambda: partials.sum(1)),
                nbytes=partials.numel() * 4 + 2 * hidden * 4,
                ops=float(partials.numel()), dtype=torch.float32))
    for rows, hid, dtype, wdt, rms in LN_PROBES:
        what = (f"{str(dtype)[6:]} x, {str(wdt)[6:]} parameters, "
                f"{'RMSNorm' if rms else 'layer norm'} rows={rows} "
                f"hidden={hid}")
        x = randn(rows, hid, dtype=dtype, scale=3.0, shift=0.5)
        wp = randn(hid, dtype=wdt, scale=0.1, shift=1.0)
        bp = None if rms else randn(hid, dtype=wdt, scale=0.1)
        got = ln.layer_norm_fwd(x, wp, bp, 1e-5, rms)
        want = ln._ln_fwd_plain(x, wp, bp, 1e-5, rms)
        check("ln_fwd", got[0], want[0], f"{what} y")
        check("ln_fwd", got[2], want[2], f"{what} invvar")
        dy = randn(rows, hid, dtype=dtype)
        bdt = None if rms else wdt
        args = (dy, x, wp, bdt, want[1], want[2], rms)
        got = ln.layer_norm_bwd(*args)
        ln_bwd_check("ln_bwd", got, ln._ln_bwd_plain(*args), what)
        same_bits("ln_bwd", got, ln.layer_norm_bwd(*args), what)
    return records


def decode_kernels(randn, dev) -> dict:
    """``paged_decode`` against its plain version at the decode step's
    4-slot layout (lengths 0/1/300/576, pages of 64, NaN on the null
    page), fp32, bf16 and fp16 (``paged_decode_f16``), sq 1 and 4, beside
    the many-row instance at the same layout, then with the fused
    q-RoPE; the 16-bit rows timed."""
    from apex_tpu_torch.ops import attention_decode as dec

    records = {}
    heads = FLAGSHIP["num_attention_heads"]
    d = FLAGSHIP["hidden_size"] // heads
    # -- paged decode: 4 slots, 9 pages of 64, ragged incl. idle --------
    log("[kernels] paged_decode (CUDA), 4 slots h=8 d=128 page 64 x 9")
    page, pps = 64, 9
    lengths = torch.tensor([0, 1, 300, 576], dtype=torch.int32)
    num_pages = 1 + int(sum(-(-int(n) // page) for n in lengths))
    perm = torch.randperm(num_pages - 1, generator=torch.Generator()
                          .manual_seed(1)) + 1
    table = torch.zeros((4, pps), dtype=torch.int32)
    at = 0
    for i, n in enumerate(lengths.tolist()):
        used = -(-n // page)
        table[i, :used] = perm[at:at + used]
        at += used
    table, lengths = table.to(dev), lengths.to(dev)
    for dtype in (torch.float32,) + SM90_DTYPES:
        kp = randn(num_pages, heads, page, d, dtype=dtype)
        vp = randn(num_pages, heads, page, d, dtype=dtype)
        kp[0] = float("nan")        # garbage on the null page stays out
        vp[0] = float("nan")
        for sq in (1, 4):
            q = randn(4, heads, sq, d, dtype=dtype)
            got = dec.fmha_decode(q, kp, vp, table, lengths)
            want = dec.paged_attention_reference(q, kp, vp, table, lengths)
            err = check("paged_decode", got, want,
                        f"{str(dtype)[6:]} sq={sq} out")
            if not torch.isfinite(got).all():
                fail("paged_decode: non-finite output")
            with many_row_instance(dec):
                check("paged_decode_rows", dec.fmha_decode(
                    q, kp, vp, table, lengths), want,
                    f"{str(dtype)[6:]} sq={sq} out (decode layout)")
            if dtype not in SM90_DTYPES:
                continue
            if dtype == torch.bfloat16:
                small, _ = time_ms(lambda: dec.fmha_decode(
                    q, kp, vp, table, lengths))
                with many_row_instance(dec):
                    many, _ = time_ms(lambda: dec.fmha_decode(
                        q, kp, vp, table, lengths))
                log(f"  bf16 sq={sq}, same layout: paged_decode {small:.4f} "
                    f"ms, the many-row instance {many:.4f} ms on the device")
            if sq != 1:
                continue
            toks = int(lengths.sum())
            name = f16("paged_decode", dtype)
            records[name] = [measure(
                name, "4 slots, lengths 0/1/300/576, h=8 d=128 page=64 "
                f"{short_name(dtype)}", err,
                lambda: dec.fmha_decode(q, kp, vp, table, lengths),
                lambda: dec.paged_attention_reference(
                    q, kp, vp, table, lengths),
                None,
                nbytes=2 * q.numel() * q.element_size()
                + 2 * toks * heads * d * kp.element_size()
                + table.numel() * 4 + lengths.numel() * 4,
                ops=4.0 * d * heads * toks, dtype=dtype)]

    # -- the fused q-RoPE: the rope table's rows at each query position,
    #    as the Llama-mode decode step hands them to the kernel
    log("[kernels] paged_decode with the fused q-RoPE, same layout")
    from apex_tpu_torch.ops.rope import rope_table

    cos_t, sin_t = rope_table(pps * page, d, device=dev)
    for dtype in (torch.float32,) + SM90_DTYPES:
        kp = randn(num_pages, heads, page, d, dtype=dtype)
        vp = randn(num_pages, heads, page, d, dtype=dtype)
        for sq in (1, 4):
            q = randn(4, heads, sq, d, dtype=dtype)
            pos = (lengths[:, None].long() - sq
                   + torch.arange(sq, device=dev)).clamp_min(0)
            rope = (cos_t[pos], sin_t[pos])
            got = dec.fmha_decode(q, kp, vp, table, lengths, rope=rope)
            want = dec._decode_plain(q, kp, vp, table, lengths, True,
                                     d ** -0.5, rope)
            check("paged_decode", got, want,
                  f"{str(dtype)[6:]} sq={sq} with rope out")
            if dtype == torch.bfloat16 and sq == 1:
                with_rope, _ = time_ms(lambda: dec.fmha_decode(
                    q, kp, vp, table, lengths, rope=rope))
                without, _ = time_ms(lambda: dec.fmha_decode(
                    q, kp, vp, table, lengths))
                log(f"  paged_decode bf16 sq=1: {with_rope:.4f} ms with the "
                    f"fused q-RoPE, {without:.4f} ms without")
    return records


#: the flagship's projections (k, n) at the decode shape (m = 4 slots),
#: qkv at a tree verify (4 slots of offramp_tree(4)'s 9 rows), fc1 at a
#: 256-token chunk and a 512-token prefill, and qkv and fc2 at
#: serve-quant-long's 2304-token prefill
DEQUANT_SHAPES = (("qkv", 4, 1024, 3072), ("attn_proj", 4, 1024, 1024),
                  ("fc1", 4, 1024, 4096), ("fc2", 4, 4096, 1024),
                  ("qkv", 36, 1024, 3072), ("fc1", 256, 1024, 4096),
                  ("fc1", 512, 1024, 4096), ("qkv", 2304, 1024, 3072),
                  ("fc2", 2304, 4096, 1024))

#: the store paths phase 2 must reach, by the plan's regime, x's dtype
#: (the tiled kernel has both) and whether k is split
DEQUANT_REQUIRED = ("decode, one split, direct store", "decode, ticket merge",
                    "wgmma bf16, direct store", "wgmma bf16, ticket merge",
                    "wgmma fp16, direct store", "wgmma fp16, ticket merge",
                    "fp32 tiled, direct store", "fp32 tiled, ticket merge",
                    "bf16 tiled, direct store", "fp16 tiled, direct store")

#: the share of 16-bit outputs that may differ from the plain version's:
#: a kernel that sums the fp32 products and rounds once differs only where
#: the two orders of summation fall on either side of a rounding boundary
#: (about 0.3% of the outputs); one bf16 pass over the weights (each w
#: rounded to 8 bits) moves about 40% of them.  In fp16 no output may be
#: more than one ulp off
DEQUANT_FLIP_LIMIT = 0.01

#: the x types phase 2 holds the dequant pair at
DEQUANT_DTYPES = (torch.bfloat16, torch.float32, torch.float16)


def dequant_path(plan, dtype) -> str:
    """The store path of a call: its kernel and whether k is split."""
    kernel = ("decode" if plan.regime == "decode" else
              f"{plan.regime} {short_name(dtype)}" if plan.regime == "wgmma"
              else f"{short_name(dtype)} tiled")
    if plan.splits > 1:
        return f"{kernel}, ticket merge"
    return f"{kernel}, one split, direct store" if plan.regime == "decode" \
        else f"{kernel}, direct store"


def bf16_flips(got, want) -> float:
    """The share of the elements of two bf16 results that differ."""
    return (got != want).float().mean().item()


def ulps_off(got, want, noise) -> float:
    """The largest distance of ``got`` from ``want`` in fp16 ulps at each
    element of ``want`` (equal elements, infs included, are 0 off), the
    ulp never taken below ``noise``: the typical rounding error of an fp32
    sum of the same products, sqrt(k) 2**-24 sum |x_i w_i| (an output that
    cancels below it differs between any two orders of summation, the
    tensor cores' accumulator among them, by more than its fp16 ulp)."""
    g, w = got.float(), want.float()
    ulp = torch.maximum(torch.exp2(torch.floor(torch.log2(
        w.abs().clamp_min(2.0 ** -14))) - 10), noise)
    off = torch.where(g == w, 0.0, (g - w).abs() / ulp)
    return off.max().item()


def check_rounded_once(kernel: str, got, plain, one_pass, what: str,
                       noise=None) -> None:
    """A 16-bit result must be the fp32 sum rounded once: no more than
    :data:`DEQUANT_FLIP_LIMIT` of its elements off the plain version's,
    and (fp16) none by more than one ulp (:func:`ulps_off`, ``noise`` the
    fp32 sums' rounding error at each output).  ``one_pass``, the same
    product from weights rounded to x's type, must miss that limit, or the
    check could not tell the two apart."""
    flips, alone = bf16_flips(got, plain), bf16_flips(one_pass, plain)
    ty = short_name(got.dtype)
    if alone < DEQUANT_FLIP_LIMIT:
        fail(f"{kernel} {what}: a one-pass {ty} product differs from the "
             f"plain version in only {alone:.2%} of the outputs: the check "
             f"cannot tell it from the fp32 function")
    if flips >= DEQUANT_FLIP_LIMIT:
        fail(f"{kernel} {what}: {flips:.3%} of the outputs differ from the "
             f"plain version (limit {DEQUANT_FLIP_LIMIT:.0%}; a one-pass "
             f"{ty} product: {alone:.2%})")
    off = (ulps_off(got, plain, noise) if got.dtype == torch.float16
           else None)
    if off is not None and not off <= 1.0:
        fail(f"{kernel} {what}: an output {off:.3g} fp16 ulps off the plain "
             "version's one rounding (limit 1)")
    log(f"  {kernel} {what}: {flips:.3%} of the outputs off the plain "
        f"version (limit {DEQUANT_FLIP_LIMIT:.0%}; a one-pass {ty} "
        f"product: {alone:.2%})"
        + ("" if off is None else f", at most {off:.0f} ulp off"))


def dequant_kernels(randn) -> dict:
    """``dequant_int8`` and ``dequant_int4`` against their plain versions,
    block 128, bf16, fp32 and fp16 x (the ``_f16`` instances), at
    :data:`DEQUANT_SHAPES`, each called twice (the same bits: the k split
    is merged in a fixed order).  A 16-bit result is held to
    :func:`tolerance` and, elementwise, to :func:`check_rounded_once`.
    The bound is the bytes moved (x, the quantized weights and scales, the
    output) or the arithmetic: 2mkn at the tensor cores' 16-bit rate for
    the 16-bit-x prefill rows (the wgmma kernel), and 2mkn plus one
    dequantizing multiply per weight at the fp32 rate for the others.  No
    PyTorch call takes block-scaled int8/int4 weights: the bf16 rows have
    no library time, and a separate reading is ``torch.matmul`` on the
    dense bf16 weight at each shape, the time the quantized pool has to
    beat; the fp16 rows carry ``torch.matmul`` on the dense fp16 weight
    as their library time, that same yardstick.

    The plan (``dequant_plan``) sends each call to a kernel and a k split;
    the shapes must reach every store path of :data:`DEQUANT_REQUIRED`, or
    the phase fails.  No flagship projection leaves the decode kernel one
    split, so a probe as wide as two feature tiles an SM (k = 256) reaches
    its direct store; none sends bf16 x to the tiled kernel, which takes
    it over int4 weights whose n / 2 is an odd multiple of 8, so a probe
    of block 8 reaches that."""
    from apex_tpu_torch.ops.dequant_matmul import (
        dequant_matmul, dequant_matmul_reference, dequant_plan,
        dequantize_weight, quantize_weight)

    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    both = ("int8", "int4")
    shapes = tuple(shape + (both, 128) for shape in DEQUANT_SHAPES) + (
        ("direct-store probe", 4, 256, 256 * sms, both, 128),
        ("bf16-tiled probe", 64, 256, 2064, ("int4",), 8))
    plans = {(shape, wd, dtype): dequant_plan(*shape[1:4], wd, dtype, sms)
             for shape in shapes for wd in shape[4]
             for dtype in DEQUANT_DTYPES}
    reached = {dequant_path(p, key[2]) for key, p in plans.items()}
    missing = [path for path in DEQUANT_REQUIRED if path not in reached]
    if missing:
        fail(f"dequant: the shapes reach {sorted(reached)}, not {missing}")
    log(f"[kernels] dequant_int8, dequant_int4 (CUDA); store paths "
        f"reached: {sorted(reached)}")
    records = {}
    for shape in shapes:
        name, m, k, n, wds, block = shape
        w = randn(k, n, scale=0.02)
        for wd in wds:
            kernel = f"dequant_{wd}"
            pool = quantize_weight(w, wd, block)
            q, s = pool["q8" if wd == "int8" else "q4"], pool["scales"]
            wide = dequantize_weight(pool)
            for dtype in DEQUANT_DTYPES:
                x = randn(m, k, dtype=dtype)
                plan = plans[(shape, wd, dtype)]
                what = (f"{name} m={m} k={k} n={n} block {block} x "
                        f"{str(dtype)[6:]} ({plan.regime}"
                        + (f", {plan.tile}-token tiles" if plan.tile else "")
                        + (f", k in {plan.splits} splits)" if plan.splits > 1
                           else ", k whole)"))
                run = lambda: dequant_matmul(x, q, s, weight_dtype=wd)
                plain = lambda: dequant_matmul_reference(
                    x, q, s, weight_dtype=wd, block_size=block)
                got, want = run(), plain()
                err = check(kernel, got, want, what)
                if dtype != torch.float32:
                    noise = k ** 0.5 * 2.0 ** -24 * torch.matmul(
                        x.float().abs(), wide.abs())
                    check_rounded_once(
                        kernel, got, want, torch.matmul(
                            x.float(), wide.to(dtype).float()).to(dtype),
                        what, noise)
                if not torch.equal(got, run()):
                    fail(f"{kernel} {what}: a second call gave other bits")
                rate = dtype if plan.regime == "wgmma" else torch.float32
                ops = 2.0 * m * k * n + (k * n if rate == torch.float32
                                         else 0)
                dense = wide.to(dtype)
                library = (("dense fp16 torch.matmul",
                            lambda: torch.matmul(x, dense))
                           if dtype == torch.float16 else None)
                records.setdefault(f16(kernel, dtype), []).append(measure(
                    f16(kernel, dtype), what, err, run, plain, library,
                    nbytes=x.numel() * x.element_size() + q.numel()
                    + s.numel() * 4 + m * n * x.element_size(),
                    ops=ops, dtype=rate))
        xb, wb = randn(m, k, dtype=torch.bfloat16), w.to(torch.bfloat16)
        ms, _ = time_ms(lambda: torch.matmul(xb, wb))
        log(f"  dense bf16 torch.matmul {name} m={m} k={k} n={n}: "
            f"{ms:.4f} ms on the device")
    return records


@contextlib.contextmanager
def many_row_instance(dec):
    """Send every decode call to the many-row instance, so phase 2 can
    hold and time it at the decode step's few rows beside the small
    kernel that serves them."""
    saved = dec.FMHA_DECODE_MAX_SQ
    dec.FMHA_DECODE_MAX_SQ = 0
    try:
        yield
    finally:
        dec.FMHA_DECODE_MAX_SQ = saved


def paged_layout(lengths, page: int, pps: int, dev):
    """A page table for ``lengths`` cached tokens a slot, its pages
    scattered through the pool (page 0, the null page, unused): returns
    ``(table, lengths, num_pages)`` on ``dev``."""
    num_pages = 1 + sum(-(-n // page) for n in lengths)
    perm = torch.randperm(num_pages - 1, generator=torch.Generator()
                          .manual_seed(1)) + 1
    table = torch.zeros((len(lengths), pps), dtype=torch.int32)
    at = 0
    for i, n in enumerate(lengths):
        used = -(-n // page)
        table[i, :used] = perm[at:at + used]
        at += used
    return (table.to(dev), torch.tensor(lengths, dtype=torch.int32,
                                        device=dev), num_pages)


def decode_int8_kernels(randn, dev) -> dict:
    """``paged_decode_int8`` against its plain version (bf16, fp16 and
    fp32 q, sq 1 and 4) over pages the cache's quantizer made from random
    rows, at phase 2's 4-slot layout (877 cached tokens) and at
    serve-long's 2300 tokens a slot; timed at 16-bit q, sq=1 (fp16:
    ``paged_decode_int8_f16``), beside the 16-bit pages' kernel over the
    same values dequantized."""
    from apex_tpu_torch.ops import attention_decode as dec
    from apex_tpu_torch.ops.quantization import quantize_rows

    heads, d, page = FLAGSHIP["num_attention_heads"], 128, 64
    records = {}
    log(f"[kernels] paged_decode_int8 (CUDA), 4 slots h={heads} d={d} page "
        f"{page}, kv_block 128")
    for lengths, pps in (([0, 1, 300, 576], 9), ([2300] * 4, 37)):
        table, lens, num_pages = paged_layout(lengths, page, pps, dev)
        pages = []
        for _ in range(2):
            vals, sc = quantize_rows(
                randn(num_pages * heads * page, d), 128)
            pages.append((vals.view(num_pages, heads, page, d),
                          sc.view(num_pages, heads, page, 1)))
        (kp, ks), (vp, vs) = pages
        toks = sum(lengths)
        for dtype in SM90_DTYPES + (torch.float32,):
            for sq in (1, 4):
                q = randn(4, heads, sq, d, dtype=dtype)
                run = lambda: dec.fmha_decode(q, kp, vp, table, lens,
                                              k_scales=ks, v_scales=vs)
                plain = lambda: dec.paged_attention_reference(
                    q, kp, vp, table, lens, k_scales=ks, v_scales=vs)
                what = f"{str(dtype)[6:]} sq={sq} {toks} cached tokens"
                err = check("paged_decode_int8", run(), plain(), what)
                if dtype not in SM90_DTYPES or sq != 1:
                    continue
                name = f16("paged_decode_int8", dtype)
                records.setdefault(name, []).append(measure(
                    name,
                    f"4 slots, lengths {'/'.join(map(str, lengths))}, "
                    f"h={heads} d={d} page={page} int8 pages, "
                    f"{short_name(dtype)} q", err,
                    run, plain,
                    None,
                    nbytes=2 * q.numel() * q.element_size()
                    + 2 * toks * heads * (d + 4) + table.numel() * 4
                    + lens.numel() * 4,
                    ops=4.0 * d * heads * toks, dtype=dtype))
                kb, vb = ((p.float() * sc).to(dtype) for p, sc in pages)
                wide_ms, _ = time_ms(lambda: dec.fmha_decode(
                    q, kb, vb, table, lens))
                log(f"  paged_decode over {short_name(dtype)} pages, same "
                    f"layout: {wide_ms:.4f} ms on the device")
    return records


#: the split decode kernels' span-edge cases in phase 2: (label, entry,
#: lengths, page size, pages a slot, query rows, head dim, causal, tree);
#: lengths sit at a span's last position, the next span's first two and
#: two spans on, beside an idle slot, in a pool whose pages_per_seq runs
#: far past them (most spans empty)
def split_cases(span: int, rows_span: int) -> tuple:
    edges = [span - 1, span, span + 1, 2 * span + 1]
    rows_edges = [rows_span - 1, rows_span, rows_span + 1, 2 * rows_span + 1]
    return (
        ("small, pages of 64", "paged_decode", [0] + edges, 64, 40, 1, 128,
         True, None),
        ("small, 4 rows", "paged_decode", [0] + edges, 64, 40, 4, 128, True,
         None),
        ("small, not causal, d=64", "paged_decode", [0] + edges, 64, 40, 4,
         64, False, None),
        ("small, pages of 16", "paged_decode", [0] + edges, 16, 160, 1, 128,
         True, None),
        ("many rows (2 tiles)", "paged_decode_rows", rows_edges, 64, 40, 72,
         128, True, None),
        ("many rows, not causal, d=64", "paged_decode_rows", rows_edges, 16,
         160, 9, 64, False, None),
        ("tree, offramp_tree(4)", "paged_decode_tree", [0] + rows_edges, 16,
         160, 9, 128, True, "offramp"),
    )


#: serve-long's decode layout: 4 slots of 2300 cached tokens, pages 64 x 37
SERVE_LONG_DECODE = ([2300] * 4, 64, 37)


def decode_split_kernels(randn, dev) -> dict:
    """The span split of the decode kernels (``csrc/attention_decode.cu``):
    the split of each entry at phase 2's shapes and at a 512-row chunk
    (span, spans, grid, workspace bytes); every entry at :func:`split_cases`
    (bf16 and fp32 pages, int8 pages, the fused q-RoPE, causal or not,
    the tree mask, d = 64 and 128, pages of 16 and 64, an idle slot, NaN
    on the null page) against its plain version and against the plain
    model of the spans (``_decode_split_plain``), at :func:`tolerance`,
    and the same bits twice, in bf16, fp16 (the ``_f16`` instances) and
    fp32; then serve-long's decode layout (:data:`SERVE_LONG_DECODE`) with
    and without the rope, held and timed in bf16 and fp16."""
    from apex_tpu_torch.ops import attention_decode as dec
    from apex_tpu_torch.ops.quantization import quantize_rows
    from apex_tpu_torch.ops.rope import rope_table
    from apex_tpu_torch.serving.speculate import offramp_tree, tree_ancestors

    heads = FLAGSHIP["num_attention_heads"]
    span, rows_span = dec.DECODE_SPAN, dec.DECODE_ROWS_SPAN
    log(f"[kernels] the decode split: spans of {span} positions (small "
        f"kernel), {rows_span} (many-row instance)")
    for what, b, sq, page, pps, rows in (
            ("paged_decode, 4 slots x 877", 4, 1, 64, 9, False),
            ("paged_decode, serve-long 4 x 2300", 4, 1, 64, 37, False),
            ("paged_decode_rows, C=256 over 512", 1, 256, 64, 8, True),
            ("paged_decode_tree, 4 x 877, R=9", 4, 9, 64, 14, True),
            ("paged_decode_rows, C=512, pages 64 x 37", 1, 512, 64, 37,
             True)):
        plan = dec._split_plan(b, heads, sq, 128, page, pps, rows)
        log(f"  {what}: span {plan.span}, n_split {plan.n_split}, grid "
            f"{plan.grid}, workspace {4 * plan.workspace} bytes, "
            f"{plan.counters} counters")

    def held(name, what, run, plain, model):
        got = run()
        if not torch.isfinite(got).all():
            fail(f"{name} {what}: non-finite output")
        err = check(name, got, plain(), what)
        check(name, got, model(), what + " vs the span model")
        if not torch.equal(got, run()):
            fail(f"{name} {what}: two calls gave different bits")
        return got, err

    for label, name, lengths, page, pps, sq, d, causal, tree in split_cases(
            span, rows_span):
        table, lens, num_pages = paged_layout(lengths, page, pps, dev)
        anc = None if tree is None else tree_ancestors(offramp_tree(4))
        anc_dev = None if anc is None else torch.tensor(
            anc, dtype=torch.bool, device=dev)
        cos_t, sin_t = rope_table(pps * page, d, device=dev)
        pos = (lens[:, None].long() - sq
               + torch.arange(sq, device=dev)).clamp_min(0)
        rope = (cos_t[pos], sin_t[pos])
        int8 = []
        for _ in range(2):
            vals, sc = quantize_rows(randn(num_pages * heads * page, d), 64)
            int8.append((vals.view(num_pages, heads, page, d),
                         sc.view(num_pages, heads, page, -1)))
        (k8, ks), (v8, vs) = int8
        every = "/".join(map(str, lengths))
        for dtype in SM90_DTYPES + (torch.float32,):
            kp = randn(num_pages, heads, page, d, dtype=dtype)
            vp = randn(num_pages, heads, page, d, dtype=dtype)
            kp[0] = float("nan")        # garbage on the null page stays out
            vp[0] = float("nan")
            q = randn(len(lengths), heads, sq, d, dtype=dtype)
            scale = d ** -0.5
            for extra, kw in (("", {}), (", rope", dict(rope=rope)),
                              (", int8 pages (kv_block 64)", dict(
                                  k_pages=k8, v_pages=v8, k_scales=ks,
                                  v_scales=vs, kv_block=64))):
                args = dict(dict(k_pages=kp, v_pages=vp), **kw)
                entry = ("paged_decode_int8" if name == "paged_decode"
                         and "k_scales" in kw else name)
                call = (q, args["k_pages"], args["v_pages"], table, lens,
                        causal, scale, args.get("rope"),
                        args.get("k_scales"), args.get("v_scales"),
                        args.get("kv_block", 128))
                got, _ = held(
                    entry, f"{label}, lengths {every}, page {page} x {pps}, "
                    f"sq={sq} d={d} {str(dtype)[6:]}{extra}",
                    lambda: dec.fmha_decode(
                        *call[:5], causal=causal, rope=call[7],
                        k_scales=call[8], v_scales=call[9],
                        kv_block=call[10], ancestor=anc),
                    lambda: dec._decode_plain(*call, anc_dev),
                    lambda: dec._decode_split_plain(
                        *call, anc_dev, span=rows_span if name != \
                        "paged_decode" else span))
                if lengths[0] == 0 and got[0].abs().max().item() != 0.0:
                    fail(f"{entry} {label}: the idle slot's row is not 0")

    log(f"[kernels] paged_decode at serve-long's decode layout, 4 x 2300, "
        f"h={heads} d=128 page 64 x 37")
    records = {}
    lengths, page, pps = SERVE_LONG_DECODE
    table, lens, num_pages = paged_layout(lengths, page, pps, dev)
    cos_t, sin_t = rope_table(pps * page, 128, device=dev)
    toks = sum(lengths)
    for dtype in SM90_DTYPES + (torch.float32,):
        kp = randn(num_pages, heads, page, 128, dtype=dtype)
        vp = randn(num_pages, heads, page, 128, dtype=dtype)
        for sq in (1, 4):
            q = randn(4, heads, sq, 128, dtype=dtype)
            pos = lens[:, None].long() - sq + torch.arange(sq, device=dev)
            for extra, rope in (("", None), (" with rope",
                                             (cos_t[pos], sin_t[pos]))):
                call = (q, kp, vp, table, lens, True, 128 ** -0.5, rope)
                run = (lambda call=call: dec.fmha_decode(
                    *call[:5], rope=call[7]))
                plain = (lambda call=call: dec._decode_plain(*call))
                _, err = held("paged_decode", f"4 x 2300 sq={sq} "
                              f"{str(dtype)[6:]}{extra}", run, plain,
                              lambda call=call: dec._decode_split_plain(
                                  *call, span=span))
                if dtype not in SM90_DTYPES or sq != 1:
                    continue
                name = f16("paged_decode", dtype)
                records.setdefault(name, []).append(measure(
                    name, f"4 slots x 2300, h={heads} d=128 page=64 "
                    f"{short_name(dtype)}{extra}",
                    err, run, plain, None,
                    nbytes=2 * q.numel() * q.element_size()
                    + 2 * toks * heads * 128 * kp.element_size()
                    + table.numel() * 4 + lens.numel() * 4
                    + (0 if rope is None else 2 * 4 * rope[0].numel()),
                    ops=4.0 * 128 * heads * toks, dtype=dtype))
    return records


#: the decode op's many-row and tree instances in phase 2: (entry,
#: cached tokens a slot, pages a slot, query rows, tree or None, label)
DECODE_ROWS_CASES = (
    ("paged_decode_rows", [512], 8, 256, None,
     "1 slot, C=256 rows at start 256 over 512 cached tokens"),
    ("paged_decode_tree", [877] * 4, 14, 9, "offramp",
     "4 slots x 877 cached tokens, offramp_tree(4) R=9"),
    ("paged_decode_tree", [877] * 4, 14, 5, "chain",
     "4 slots x 877 cached tokens, chain_tree(4) R=5"))

#: the softmax kernel's shape in phase 2 and fused-softmax: the flagship's
#: attention scores (b=8, 8 heads, s=1024)
SOFTMAX_SHAPE = (8, 8, 1024, 1024)


def visible_pairs(lengths, sq: int, ancestor=None) -> int:
    """(query row, cached token) pairs the decode op computes for these
    lengths: causal rows see positions up to their own; tree rows see the
    committed prefix and their ancestors among the fresh rows."""
    total = 0
    for n in lengths:
        if ancestor is None:
            total += sum(max(0, min(n, n - sq + i + 1)) for i in range(sq))
        else:
            total += max(n - sq, 0) * sq + sum(map(sum, ancestor))
    return total


def decode_rows_kernels(randn, dev) -> dict:
    """The decode op's many-row instance against its plain version at a
    chunked prefill's shape (1 slot, h=8, d=128, C=256 rows at start 256
    over 512 cached tokens, page 64: ``paged_decode_rows``), and its tree
    instance at speculative verify's (4 slots of 877 cached tokens,
    ``offramp_tree(4)``'s 9 rows and ``chain_tree(4)``'s 5:
    ``paged_decode_tree``); bf16, fp16 (``_f16``), fp32, int8 pages,
    with and without the fused q-RoPE, NaN on the null page.  Timed at
    16-bit pages without rope; the int8 pages and rope timed beside it.  The bound: q in, out,
    and each slot's visible K/V once (bytes), or 4 * d flops per visible
    (row, token) pair at the bf16 rate."""
    from apex_tpu_torch.ops import attention_decode as dec
    from apex_tpu_torch.ops.quantization import quantize_rows
    from apex_tpu_torch.ops.rope import rope_table
    from apex_tpu_torch.serving.speculate import (
        chain_tree, offramp_tree, tree_ancestors)

    heads, d, page = FLAGSHIP["num_attention_heads"], 128, 64
    trees = {None: None, "offramp": offramp_tree(4), "chain": chain_tree(4)}
    records = {}
    for name, lengths, pps, sq, tree, label in DECODE_ROWS_CASES:
        log(f"[kernels] {name} (CUDA), {label}, h={heads} d={d} page {page}")
        table, lens, num_pages = paged_layout(lengths, page, pps, dev)
        anc = None if tree is None else tree_ancestors(trees[tree])
        # the plain version's mask, on the card already: a host-to-device
        # copy cannot run inside the CUDA graph that times it
        anc_dev = None if anc is None else torch.tensor(
            anc, dtype=torch.bool, device=dev)
        cos_t, sin_t = rope_table(pps * page, d, device=dev)
        pos = (lens[:, None].long() - sq
               + torch.arange(sq, device=dev)).clamp_min(0)
        rope = (cos_t[pos], sin_t[pos])
        int8 = []
        for _ in range(2):
            vals, sc = quantize_rows(randn(num_pages * heads * page, d), 128)
            int8.append((vals.view(num_pages, heads, page, d),
                         sc.view(num_pages, heads, page, 1)))
        (k8, ks), (v8, vs) = int8
        pairs = visible_pairs(lengths, sq, anc)
        for dtype in SM90_DTYPES + (torch.float32,):
            dt = str(dtype)[6:]
            kp = randn(num_pages, heads, page, d, dtype=dtype)
            vp = randn(num_pages, heads, page, d, dtype=dtype)
            kp[0] = float("nan")        # garbage on the null page stays out
            vp[0] = float("nan")
            q = randn(len(lengths), heads, sq, d, dtype=dtype)
            runs = {}
            for what, kw in (("", {}), (" with rope", dict(rope=rope)),
                             (" int8 pages", dict(k_pages=k8, v_pages=v8,
                                                  k_scales=ks,
                                                  v_scales=vs))):
                args = dict(dict(k_pages=kp, v_pages=vp), **kw)

                def run(args=args):
                    return dec.fmha_decode(
                        q, args["k_pages"], args["v_pages"], table, lens,
                        k_scales=args.get("k_scales"),
                        v_scales=args.get("v_scales"),
                        rope=args.get("rope"), ancestor=anc)

                def plain(args=args):
                    return dec._decode_plain(
                        q, args["k_pages"], args["v_pages"], table, lens,
                        True, d ** -0.5, args.get("rope"),
                        args.get("k_scales"), args.get("v_scales"), 128,
                        anc_dev)

                got = run()
                if not torch.isfinite(got).all():
                    fail(f"{name}: non-finite output")
                runs[what] = (check(name, got, plain(), f"{dt} sq={sq}{what}"),
                              run, plain)
            if dtype not in SM90_DTYPES:
                continue
            toks = sum(lengths)
            err, run, plain = runs[""]
            records.setdefault(f16(name, dtype), []).append(measure(
                f16(name, dtype), f"{label}, h={heads} d={d} page={page} "
                f"{short_name(dtype)}", err, run, plain, None,
                nbytes=2 * q.numel() * q.element_size()
                + 2 * toks * heads * d * kp.element_size()
                + table.numel() * 4 + lens.numel() * 4,
                ops=4.0 * d * heads * pairs, dtype=dtype))
            for what in (" with rope", " int8 pages"):
                ms, _ = time_ms(runs[what][1])
                log(f"  {f16(name, dtype)} {short_name(dtype)}{what}, same "
                    f"layout: {ms:.4f} ms on the device")
    return records


def softmax_read(x, mask, causal: bool) -> int:
    """Scores of x the softmax must read: a filled score (above the
    diagonal when causal, or where the mask is True) is never needed."""
    sq, sk = x.shape[-2:]
    keep = torch.ones(sq, sk, dtype=torch.bool, device=x.device)
    if causal:
        keep = keep.tril()
    if mask is not None:
        keep = keep & ~mask
    return int(torch.broadcast_to(keep, x.shape).sum())


def softmax_kernels(randn) -> dict:
    """``softmax_fwd`` (Triton) against its plain version at the
    flagship's attention-score shape (8, 8, 1024, 1024), causal and with a
    ``(b, 1, sq, sk)`` padding mask, bf16 and fp32, scale d^-0.5.  Timed
    at bf16; the library yardstick is one ``torch.softmax`` over the
    pre-scaled input (no fill), the bound the scores it must read
    (:func:`softmax_read`), y out once and the mask's bytes."""
    from apex_tpu_torch.ops import softmax as sm

    b, np_, s, _ = SOFTMAX_SHAPE
    scale = 128 ** -0.5
    log(f"[kernels] softmax_fwd (Triton), ({b}, {np_}, {s}, {s})")
    mask = randn(b, 1, s, s) > 1.0            # about 16% of keys masked
    mask[0, 0, 5] = True                      # one fully masked row
    records = {}
    for dtype in SM90_DTYPES + (torch.float32,):
        dt = str(dtype)[6:]
        x = randn(b, np_, s, s, dtype=dtype, scale=3.0)
        xs = (x.float() * scale).to(dtype)
        for causal, m, what in ((True, None, "causal"),
                                (False, mask, "padding mask")):
            run = lambda: sm._softmax_fwd(x, m, scale, causal)
            plain = lambda: sm._softmax_fwd_plain(x, m, scale, causal)
            err = check("softmax_fwd", run(), plain(), f"{dt} {what}")
            if dtype not in SM90_DTYPES:
                continue
            nbytes = (softmax_read(x, m, causal) + x.numel()) \
                * x.element_size() + (0 if m is None else m.numel())
            # one counter for both 16-bit types (the Triton kernel is
            # specialised on the pointer's type): bf16 first, the result
            # line's record
            records.setdefault("softmax_fwd", []).append(measure(
                "softmax_fwd", f"({b}, {np_}, {s}, {s}) {what} {dt}", err,
                run, plain,
                ("torch.softmax on the pre-scaled input",
                 lambda: torch.softmax(xs, dim=-1)),
                nbytes=nbytes, ops=5.0 * x.numel(), dtype=torch.float32,
                plain_iters=10))
    return records


def flash_kernels(randn) -> dict:
    """The flash rung's kernels against their plain versions on the
    flattened ``(b*h, s, d)`` layout: at the long-context training shape
    (b=2 h=8 s=4096 d=128 causal) and on ragged lengths (2500 causal, 700
    queries x 900 keys full), fp32 and bf16.  The backward kernels get
    the plain forward's ``lse`` and ``delta``, so each is held alone.
    Times at bf16 and s=4096; library calls SDPA forward, and SDPA
    forward+backward through autograd for both backward kernels.  Then a
    reading at the JAX bench's probe shape, b=2 h=8 s=8192."""
    from apex_tpu_torch.ops import attention_flash as fl
    import torch.nn.functional as F

    b, heads, d = 2, LLAMA["num_attention_heads"], 128
    scale = d ** -0.5
    records = {}
    log("[kernels] flash_fwd, flash_bwd_dkv, flash_bwd_dq (CUDA), d=128")
    for dtype in (torch.float32,) + SM90_DTYPES:
        dt = str(dtype)[6:]
        for bh, sq, sk, causal in ((b * heads, LONG_SEQ, LONG_SEQ, True),
                                   (4, 2500, 2500, True),
                                   (4, 700, 900, False)):
            if dtype == torch.float16 and sq != LONG_SEQ:
                continue        # fp16's ragged cases: bwd_sm90_kernels
            q, dout = (randn(bh, sq, d, dtype=dtype) for _ in range(2))
            k, v = (randn(bh, sk, d, dtype=dtype) for _ in range(2))
            what = f"{dt} bh={bh} sq={sq} sk={sk} causal={causal}"
            got = fl.flash_fwd(q, k, v, causal=causal)
            out, lse = fl._flash_fwd_plain(q, k, v, causal, scale)
            fwd_err = check("flash_fwd", got[0], out, f"{what} out")
            lse_err = max_err(got[1], lse)
            if not lse_err <= 1e-3:
                fail(f"flash_fwd {what} lse: error {lse_err:.3g} > 1e-3")
            delta = fl.flash_delta(out, dout)
            want = fl._flash_bwd_plain(q, k, v, dout, lse, delta, causal,
                                       scale)
            dk, dv = fl.flash_bwd_dkv(q, k, v, dout, lse, delta,
                                      causal=causal)
            dq = fl.flash_bwd_dq(q, k, v, dout, lse, delta, causal=causal)
            dq_err = check("flash_bwd_dq", dq, want[0], f"{what} dq")
            dkv_err = max(check("flash_bwd_dkv", dk, want[1], f"{what} dk"),
                          check("flash_bwd_dkv", dv, want[2], f"{what} dv"))
            if dtype not in SM90_DTYPES or sq != LONG_SEQ:
                continue
            s = LONG_SEQ
            shape = f"b={b} h={heads} s={s} d={d} causal {dt}"
            numel = q.numel() * q.element_size()
            rows = b * heads * s * 4                  # an fp32 (b*h, s) row
            pairs = b * heads * s * (s + 1) / 2       # causal (q, k) pairs
            q4, k4, v4, do4 = (t.view(b, heads, s, d)
                               for t in (q, k, v, dout))
            qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))

            def sdpa_fwd_bwd():
                o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
                torch.autograd.grad(o, (qg, kg, vg), do4)

            fb_ms = profiled_ms(sdpa_fwd_bwd)
            f_ms = profiled_ms(lambda: F.scaled_dot_product_attention(
                qg, kg, vg, is_causal=True))
            log(f"  SDPA forward+backward through autograd {shape}: "
                f"{fb_ms:.4f} ms of device time (profiler), the forward "
                f"alone {f_ms:.4f}, so the backward {fb_ms - f_ms:.4f}")
            records[f16("flash_fwd", dtype)] = [measure(
                f16("flash_fwd", dtype), shape, fwd_err,
                lambda: fl.flash_fwd(q, k, v, causal=True),
                lambda: fl._flash_fwd_plain(q, k, v, True, scale),
                ("SDPA", lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True)),
                nbytes=4 * numel + rows, ops=4.0 * d * pairs, dtype=dtype,
                plain_iters=10)]
            plain_bwd = lambda: fl._flash_bwd_plain(q, k, v, dout, lse, delta,
                                                    True, scale)
            # dK/dV: four products per (q, k) pair (s, dp, dv, dk); dQ:
            # three (s, dp, dq); each reads q, k, v, dout, lse and delta
            for name, fn, n_out, n_prod, err in (
                    ("flash_bwd_dkv", lambda: fl.flash_bwd_dkv(
                        q, k, v, dout, lse, delta, causal=True), 2, 4,
                     dkv_err),
                    ("flash_bwd_dq", lambda: fl.flash_bwd_dq(
                        q, k, v, dout, lse, delta, causal=True), 1, 3,
                     dq_err)):
                name = f16(name, dtype)
                rec = measure(name, shape, err, fn, plain_bwd, None,
                              nbytes=(4 + n_out) * numel + 2 * rows,
                              ops=2.0 * n_prod * d * pairs, dtype=dtype,
                              plain_iters=10)
                rec["library_ms"] = fb_ms
                rec["library_bwd_ms"] = fb_ms - f_ms
                log(f"  {name}: library call is SDPA forward+backward "
                    f"({fb_ms:.4f} ms), which includes a forward and the "
                    "other backward kernel's work; its backward alone "
                    f"(library_bwd_ms) {fb_ms - f_ms:.4f} ms")
                records[name] = [rec]

    # one reading at the JAX bench's probe shape
    s = 2 * LONG_SEQ
    q, k, v, dout = (randn(b * heads, s, d, dtype=torch.bfloat16)
                     for _ in range(4))
    out, lse = fl.flash_fwd(q, k, v, causal=True)
    delta = fl.flash_delta(out, dout)
    if not torch.isfinite(out).all():
        fail(f"flash_fwd s={s}: non-finite output")
    pairs = b * heads * s * (s + 1) / 2
    reading = []
    for name, fn, ops in (
            ("flash_fwd", lambda: fl.flash_fwd(q, k, v, causal=True), 4),
            ("flash_bwd_dkv", lambda: fl.flash_bwd_dkv(
                q, k, v, dout, lse, delta, causal=True), 8),
            ("flash_bwd_dq", lambda: fl.flash_bwd_dq(
                q, k, v, dout, lse, delta, causal=True), 6),
            ("SDPA forward", lambda: F.scaled_dot_product_attention(
                q.view(b, heads, s, d), k.view(b, heads, s, d),
                v.view(b, heads, s, d), is_causal=True), 4)):
        ms, _ = time_ms(fn, 10)
        bnd, _ = bound_ms(0, ops * d * pairs, torch.bfloat16)
        reading.append(f"{name} {ms:.4f} ms (bound {bnd:.4f})")
    log(f"  b={b} h={heads} s={s} d={d} causal bf16: " + ", ".join(reading))
    return records


def crossover_long(randn) -> None:
    """A mid-vs-flash reading at s in {1024, 2048, 4096} with 8192 tokens
    (b = 8192 / s, h=8, d=128, causal, bf16): device ms of each rung's
    forward and backward (the flash backward is delta, dK/dV and dQ, as
    its autograd function runs them).  Recorded only; the ladder keeps
    the JAX package's 2048."""
    from apex_tpu_torch.ops import attention_flash as fl
    from apex_tpu_torch.ops import attention_mid as mid

    heads, d = 8, 128
    log("[kernels] mid vs flash crossover, 8192 tokens, h=8 d=128 causal "
        "bf16")
    for s in (1024, 2048, LONG_SEQ):
        b = 8192 // s
        q, k, v, dout = (randn(b, heads, s, d, dtype=torch.bfloat16)
                         for _ in range(4))
        flat = [t.view(b * heads, s, d) for t in (q, k, v, dout)]
        out, lse = mid.mid_fwd(q, k, v, causal=True)
        fout, flse = fl.flash_fwd(*flat[:3], causal=True)

        def flash_bwd():
            delta = fl.flash_delta(fout, flat[3])
            fl.flash_bwd_dkv(*flat, flse, delta, causal=True)
            fl.flash_bwd_dq(*flat, flse, delta, causal=True)

        row = []
        for name, fwd, bwd in (
                ("mid", lambda: mid.mid_fwd(q, k, v, causal=True),
                 lambda: mid.mid_bwd(q, k, v, out, dout, lse, causal=True)),
                ("flash", lambda: fl.flash_fwd(*flat[:3], causal=True),
                 flash_bwd)):
            f_ms, _ = time_ms(fwd, 20)
            b_ms, _ = time_ms(bwd, 20)
            row.append(f"{name} fwd {f_ms:.4f} ms bwd {b_ms:.4f} ms")
        log(f"  s={s} b={b}: " + "; ".join(row))


def profiled_ms(fn, iters: int = 10) -> float:
    """Device ms per call of ``fn``: the kernels' device time summed by
    ``torch.profiler`` over ``iters`` calls after a warm-up.  For library
    calls through autograd, which are not captured in a CUDA graph here
    and whose eager calls the host's launch rate can outlast."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(r[0] for r in device_rows(prof))
    if busy_us == 0:
        fail("profiled_ms: the profiler saw no device time")
    return busy_us / 1e3 / iters


def attention_train_kernels(randn) -> dict:
    """The training path's attention kernels against their plain versions,
    causal, b=8 h=8 d=128, fp32 and bf16: ``short_bwd`` at s=512,
    ``mid_fwd``/``mid_bwd`` at the flagship's training length s=1024 and a
    ragged s=640 (the latter with a real lse cotangent).  The backward
    kernels get the plain forward's ``out``/``lse``, so each is held alone.
    Times at bf16 for s=512 (short) and s=1024 (mid); the library calls
    are SDPA forward and SDPA forward+backward through autograd, and for
    a backward also SDPA's backward alone (``library_bwd_ms``: the
    profiled forward+backward less a profiled forward in the same run)."""
    from apex_tpu_torch.ops import attention_mid as mid
    from apex_tpu_torch.ops import attention_short as short
    import torch.nn.functional as F

    b, heads, d = 8, FLAGSHIP["num_attention_heads"], 128
    scale = d ** -0.5
    records = {}
    log("[kernels] short_bwd, mid_fwd, mid_bwd (CUDA), b=8 h=8 d=128 causal")
    for dtype in (torch.float32,) + SM90_DTYPES:
        dt = str(dtype)[6:]
        for kind, s in (("short", 512), ("mid", 1024), ("mid", 640)):
            q, k, v, dout = (randn(b, heads, s, d, dtype=dtype)
                             for _ in range(4))
            numel = q.numel() * q.element_size()
            pairs = b * heads * s * (s + 1) / 2      # causal (q, k) pairs
            fwd_err = None
            if kind == "mid":
                got = mid.mid_fwd(q, k, v, causal=True)
                want = mid._mid_fwd_plain(q, k, v, True, scale)
                fwd_err = check("mid_fwd", got[0], want[0],
                                f"{dt} s={s} out")
                lse_err = max_err(got[1], want[1])
                if not lse_err <= 1e-3:
                    fail(f"mid_fwd {dt} s={s} lse: error {lse_err:.3g} "
                         "> 1e-3")
                log(f"  mid_fwd {dt} s={s} lse: max_abs_err {lse_err:.3g} "
                    "(tolerance 1e-3)")
            out, lse = short._short_fwd_plain(q, k, v, True, scale)
            dlse = randn(b, heads, s) if s == 640 else None
            name = f"{kind}_bwd"
            bwd, plain = ((short.short_bwd, short._short_bwd_plain)
                          if kind == "short"
                          else (mid.mid_bwd, mid._mid_bwd_plain))
            got = bwd(q, k, v, out, dout, lse, dlse, causal=True)
            want = plain(q, k, v, out, dout, lse, dlse, True, scale)
            what = f"{dt} s={s}" + (" with dlse" if dlse is not None else "")
            errs = [check(name, g, w, f"{what} {n}")
                    for g, w, n in zip(got, want, ("dq", "dk", "dv"))]
            if dtype not in SM90_DTYPES or s == 640:
                continue
            shape = f"b={b} h={heads} s={s} d={d} causal {dt}"
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

            def sdpa_fwd_bwd():
                o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
                torch.autograd.grad(o, (qg, kg, vg), dout)

            fb_ms = profiled_ms(sdpa_fwd_bwd)
            f_ms = profiled_ms(lambda: F.scaled_dot_product_attention(
                qg, kg, vg, is_causal=True))
            log(f"  SDPA forward+backward through autograd {shape}: "
                f"{fb_ms:.4f} ms of device time (profiler), the forward "
                f"alone {f_ms:.4f}, so the backward {fb_ms - f_ms:.4f}")
            if kind == "mid":
                records[f16("mid_fwd", dtype)] = [measure(
                    f16("mid_fwd", dtype), shape, fwd_err,
                    lambda: mid.mid_fwd(q, k, v, causal=True),
                    lambda: mid._mid_fwd_plain(q, k, v, True, scale),
                    ("SDPA", lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True)),
                    nbytes=4 * numel + b * heads * s * 4, ops=4.0 * d * pairs,
                    dtype=dtype)]
            # five products per (q, k) pair: s, dp, dv, dk, dq
            name = f16(name, dtype)
            rec = measure(
                name, shape, max(errs),
                lambda: bwd(q, k, v, out, dout, lse, causal=True),
                lambda: plain(q, k, v, out, dout, lse, None, True, scale),
                None, nbytes=8 * numel + b * heads * s * 4,
                ops=10.0 * d * pairs, dtype=dtype)
            rec["library_ms"] = fb_ms
            rec["library_bwd_ms"] = fb_ms - f_ms
            log(f"  {name}: library call is SDPA forward+backward "
                f"({fb_ms:.4f} ms), which includes a forward; its backward "
                f"alone (library_bwd_ms) {fb_ms - f_ms:.4f} ms")
            records[name] = [rec]
    crossover(randn)
    return records


def crossover(randn) -> None:
    """A first short-vs-mid reading at s in {256, 384, 512} (b=8 h=8
    d=128 causal bf16): device ms of forward and backward on each rung.
    Recorded only; the ladder's boundary stays the JAX package's 512."""
    from apex_tpu_torch.ops import attention_mid as mid
    from apex_tpu_torch.ops import attention_short as short

    b, heads, d = 8, FLAGSHIP["num_attention_heads"], 128
    log("[kernels] short vs mid crossover, b=8 h=8 d=128 causal bf16")
    for s in (256, 384, 512):
        q, k, v, dout = (randn(b, heads, s, d, dtype=torch.bfloat16)
                         for _ in range(4))
        out, lse = short.short_fwd(q, k, v, causal=True)
        row = []
        for name, fwd, bwd in (("short", short.short_fwd, short.short_bwd),
                               ("mid", mid.mid_fwd, mid.mid_bwd)):
            f_ms, _ = time_ms(lambda: fwd(q, k, v, causal=True))
            b_ms, _ = time_ms(lambda: bwd(q, k, v, out, dout, lse,
                                          causal=True))
            row.append(f"{name} fwd {f_ms:.4f} ms bwd {b_ms:.4f} ms")
        log(f"  s={s}: " + "; ".join(row))


#: the segment-id variants' shapes: BERT-large's training shape on the
#: short rung (b=16 h=16 s=512 d=64), packed documents at the mid rung's
#: s=1024 (b=8, the same 8192 tokens) and the flash rung's s=4096 (b=2)
SEG_SHAPES = (("short", 16, 512), ("mid", 8, 1024), ("flash", 2, 4096))
SEG_HEADS, SEG_D = 16, 64


def segment_ids(kind: str, b: int, s: int, dev, seed: int = 0):
    """``(q_ids, kv_ids)`` ``(b, s)`` int32 on ``dev``.  ``"bert"``:
    BERT's padding, every query 0 and keys past a length drawn in
    128..s -2; ``"docs"``: each row packed with documents of 64..s/2
    tokens, equal ids on both sides; ``"fmha"``: documents up to a
    length drawn in s/4..3s/4, then fmha's padding, queries -1 and keys
    -2, so the padded query rows see no key."""
    rng = np.random.default_rng(seed)
    pos = np.arange(s)
    if kind == "bert":
        lens = rng.integers(128, s + 1, b)
        kv = np.where(pos[None] < lens[:, None], 0, -2)
        return (torch.zeros((b, s), dtype=torch.int32, device=dev),
                torch.as_tensor(kv, dtype=torch.int32, device=dev))
    ids = np.empty((b, s), np.int64)
    for r in range(b):
        cuts = np.cumsum(rng.integers(64, s // 2 + 1, s // 64))
        ids[r] = np.searchsorted(cuts, pos, side="right")
    q, kv = ids, ids.copy()
    if kind == "fmha":
        lens = rng.integers(s // 4, 3 * s // 4 + 1, b)
        q = np.where(pos[None] < lens[:, None], ids, -1)
        kv = np.where(pos[None] < lens[:, None], ids, -2)
    return (torch.as_tensor(q, dtype=torch.int32, device=dev),
            torch.as_tensor(kv, dtype=torch.int32, device=dev))


def seg_pairs(q_ids, kv_ids) -> int:
    """(query, key) pairs with equal ids, over the batch: the pairs whose
    scores the function needs (one head)."""
    return int((q_ids[:, :, None] == kv_ids[:, None, :]).sum())


def segment_kernels(randn) -> dict:
    """The seven segment-id variants against their plain versions, fp32
    and bf16, at :data:`SEG_SHAPES`: BERT's key padding (-2), packed
    documents, and fmha's padding with fully masked query rows (-1),
    whose outputs and dq must be exactly 0 and whose dK/dV share no
    garbage.  The backward kernels get the plain forward's ``out`` and
    ``lse``.  Times at bf16 on the masks without dead rows (BERT's on the
    short rung, packed documents on the mid and flash rungs), with the
    bound counted over the pairs that mask leaves visible; the library
    call is SDPA with the equivalent boolean mask (forward, and forward
    plus backward through autograd for the backward kernels)."""
    from apex_tpu_torch.ops import attention_flash as fl
    from apex_tpu_torch.ops import attention_mid as mid
    from apex_tpu_torch.ops import attention_short as short

    heads, d = SEG_HEADS, SEG_D
    scale = d ** -0.5
    records = {}
    log(f"[kernels] segment-id variants (CUDA), h={heads} d={d}, not causal")
    for rung, b, s in SEG_SHAPES:
        timed_kind = "bert" if rung == "short" else "docs"
        for dtype in (torch.float32,) + SM90_DTYPES:
            dt = str(dtype)[6:]
            for kind in (timed_kind, "fmha"):
                if dtype == torch.float16 and kind != timed_kind:
                    continue    # fp16's ragged cases: bwd_sm90_kernels
                q, k, v, dout = (randn(b, heads, s, d, dtype=dtype)
                                 for _ in range(4))
                qi, ki = segment_ids(kind, b, s, q.device, seed=s + b)
                ids = dict(q_segment_ids=qi, kv_segment_ids=ki)
                dead = ~(qi[:, :, None] == ki[:, None, :]).any(-1)
                rows = dead[:, None, :].expand(b, heads, s)
                what = f"{dt} b={b} s={s} {kind}"
                out, lse = short._short_fwd_plain(q, k, v, False, scale,
                                                  qi, ki)
                if rung == "flash":
                    flat = [t.reshape(b * heads, s, d) for t in
                            (q, k, v, dout)]
                    fids = dict(ids, heads=heads)
                    got, got_lse = fl.flash_fwd(*flat[:3], **fids)
                    got, got_lse = (got.view(b, heads, s, d),
                                    got_lse.view(b, heads, s))
                    want, want_lse = fl._flash_fwd_plain(
                        *flat[:3], False, scale, qi, ki, heads)
                    want, want_lse = want.view_as(q), want_lse.view_as(lse)
                    fo, fl_lse = out.reshape(b * heads, s, d), \
                        lse.reshape(b * heads, s)
                    delta = fl.flash_delta(fo, flat[3])
                    wq, wk, wv = (t.view_as(q) for t in fl._flash_bwd_plain(
                        *flat, fl_lse, delta, False, scale, qi, ki, heads))
                    gk, gv = (t.view_as(q) for t in fl.flash_bwd_dkv(
                        *flat, fl_lse, delta, **fids))
                    gq = fl.flash_bwd_dq(*flat, fl_lse, delta,
                                         **fids).view_as(q)
                    names = tuple(f16(n, dtype) for n in (
                        "flash_fwd_seg", "flash_bwd_dq_seg",
                        "flash_bwd_dkv_seg"))
                else:
                    fwd, bwd = ((short.short_fwd, short.short_bwd)
                                if rung == "short"
                                else (mid.mid_fwd, mid.mid_bwd))
                    got, got_lse = fwd(q, k, v, **ids)
                    want = out
                    wq, wk, wv = short._short_bwd_plain(
                        q, k, v, out, dout, lse, None, False, scale, qi, ki)
                    gq, gk, gv = bwd(q, k, v, out, dout, lse, **ids)
                    names = (f16(f"{rung}_fwd_seg", dtype),) + (
                        f16(f"{rung}_bwd_seg", dtype),) * 2
                    want_lse = lse
                fwd_err = check(names[0], got, want, f"{what} out")
                live = ~rows
                lse_err = max_err(got_lse[live], want_lse[live])
                if not lse_err <= 1e-3:
                    fail(f"{names[0]} {what} lse: error {lse_err:.3g} > 1e-3")
                dq_err = check(names[1], gq, wq, f"{what} dq")
                dkv_err = max(check(names[2], gk, wk, f"{what} dk"),
                              check(names[2], gv, wv, f"{what} dv"))
                if rows.any():
                    if got[rows].abs().max() != 0 or gq[rows].abs().max() != 0:
                        fail(f"{names[0]} {what}: a fully masked query row "
                             "has a non-zero output or dq")
                    if not (got_lse[rows] < -1e29).all():
                        fail(f"{names[0]} {what}: a fully masked row's lse "
                             "is not about -1e30")
                    log(f"  {what}: {int(dead.sum())} fully masked query "
                        "rows give out 0 and dq 0 exactly")
                if dtype not in SM90_DTYPES or kind != timed_kind:
                    continue
                records.update(seg_records(
                    rung, b, s, q, k, v, dout, out, lse, qi, ki, names,
                    (fwd_err, dq_err, dkv_err)))
    return records


def seg_records(rung, b, s, q, k, v, dout, out, lse, qi, ki, names, errs):
    """Time one rung's segment variants (bf16) beside their plain
    versions and SDPA under the equivalent boolean mask."""
    from apex_tpu_torch.ops import attention_flash as fl
    from apex_tpu_torch.ops import attention_mid as mid
    from apex_tpu_torch.ops import attention_short as short
    import torch.nn.functional as F

    heads, d = SEG_HEADS, SEG_D
    scale = d ** -0.5
    ids = dict(q_segment_ids=qi, kv_segment_ids=ki)
    mask = (qi[:, :, None] == ki[:, None, :])[:, None]        # (b, 1, s, s)
    pairs = heads * seg_pairs(qi, ki)
    shape = (f"b={b} h={heads} s={s} d={d} {dtype_name(q.dtype)}, "
             f"{pairs / (b * heads * s * s):.3f} of the pairs visible")
    numel = q.numel() * q.element_size()
    rows = b * heads * s * 4                  # an fp32 (b*h, s) row
    id_bytes = 2 * qi.numel() * 4
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
        torch.autograd.grad(o, (qg, kg, vg), dout)

    fb_ms = profiled_ms(sdpa_fwd_bwd)
    sdpa = ("SDPA (boolean mask)", lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask))
    iters = 10 if rung == "flash" else 50
    recs = {}
    if rung == "flash":
        flat = [t.reshape(b * heads, s, d) for t in (q, k, v, dout)]
        fo, flse = out.reshape(b * heads, s, d), lse.reshape(b * heads, s)
        delta = fl.flash_delta(fo, flat[3])
        fids = dict(ids, heads=heads)
        recs[names[0]] = measure(
            names[0], shape, errs[0],
            lambda: fl.flash_fwd(*flat[:3], **fids),
            lambda: fl._flash_fwd_plain(*flat[:3], False, scale, qi, ki,
                                        heads),
            sdpa, nbytes=4 * numel + rows + id_bytes, ops=4.0 * d * pairs,
            dtype=q.dtype, plain_iters=iters)
        plain_bwd = lambda: fl._flash_bwd_plain(*flat, flse, delta, False,
                                                scale, qi, ki, heads)
        # dK/dV: four products per visible pair, dQ three; each reads q,
        # k, v, dout, lse, delta and the ids
        for name, fn, n_out, n_prod, err in (
                (names[2], lambda: fl.flash_bwd_dkv(*flat, flse, delta,
                                                    **fids), 2, 4, errs[2]),
                (names[1], lambda: fl.flash_bwd_dq(*flat, flse, delta,
                                                   **fids), 1, 3, errs[1])):
            recs[name] = measure(
                name, shape, err, fn, plain_bwd, None,
                nbytes=(4 + n_out) * numel + 2 * rows + id_bytes,
                ops=2.0 * n_prod * d * pairs, dtype=q.dtype,
                plain_iters=iters)
        # the instances without ids at this shape, every pair visible:
        # what the predicate costs where no tile is skipped on the ids
        for name, fn in (
                (names[2], lambda: fl.flash_bwd_dkv(*flat, flse, delta)),
                (names[1], lambda: fl.flash_bwd_dq(*flat, flse, delta))):
            base_ms, _ = time_ms(fn, iters)
            log(f"  {name}: {recs[name]['ms'] / base_ms:.3f}x the same "
                f"kernel without the ids ({base_ms:.4f} ms) at this shape")
            recs[name]["ms_without_ids"] = base_ms
    else:
        fwd, bwd = ((short.short_fwd, short.short_bwd) if rung == "short"
                    else (mid.mid_fwd, mid.mid_bwd))
        recs[names[0]] = measure(
            names[0], shape, errs[0], lambda: fwd(q, k, v, **ids),
            lambda: short._short_fwd_plain(q, k, v, False, scale, qi, ki),
            sdpa, nbytes=4 * numel + rows + id_bytes, ops=4.0 * d * pairs,
            dtype=q.dtype, plain_iters=iters)
        # five products per visible pair: s, dp, dv, dk, dq
        recs[names[1]] = measure(
            names[1], shape, max(errs[1:]),
            lambda: bwd(q, k, v, out, dout, lse, **ids),
            lambda: short._short_bwd_plain(q, k, v, out, dout, lse, None,
                                           False, scale, qi, ki),
            None, nbytes=8 * numel + rows + id_bytes, ops=10.0 * d * pairs,
            dtype=q.dtype, plain_iters=iters)
    for name in names[1:]:
        recs[name]["library_ms"] = fb_ms
    log(f"  {rung} backward: library call is SDPA forward+backward with the "
        f"boolean mask ({fb_ms:.4f} ms of device time), which includes a "
        "forward")
    return {name: [rec] for name, rec in recs.items()}


# ------------------------------------------------------------- dropout
#: the attention dropout of phase 2's checks: the flagship's rate and a
#: seed with its top bit set
DROP_RATE = 0.1
DROP_SEED = 0x9E3779B9
#: the dropout instances' shapes, each its row's without dropout: (rung,
#: b, h, s, d, causal, segment ids, the kernels timed at this shape)
DROP_SHAPES = (
    ("short", 1, 8, 512, 128, True, None, ("short_fwd_drop",)),
    ("short", 8, 8, 512, 128, True, None, ("short_bwd_drop",)),
    ("mid", 8, 8, 1024, 128, True, None, ("mid_fwd_drop", "mid_bwd_drop")),
    ("flash", 2, 8, LONG_SEQ, 128, True, None,
     ("flash_fwd_drop", "flash_bwd_dkv_drop", "flash_bwd_dq_drop")),
    ("short", 16, SEG_HEADS, 512, SEG_D, False, "bert",
     ("short_fwd_seg_drop", "short_bwd_seg_drop")),
)


#: phase 2's draws: a decode step's 4 slots and a k=4 chain verify of 4
#: slots (20 rows), over the flagship's vocabulary
GUMBEL_ROWS = (4, 20)
#: ctx values held a case (256 before the fp16 phases came, cut to keep
#: the script's wall near half of its 1200 s limit; each value is one
#: plain draw of every row, some 15 ms)
GUMBEL_CTX = 64
#: a row may go either way when the plain version's top two ``y + g``
#: lie within this many fp32 ulps of the larger; such rows are counted,
#: and may be at most this share of the rows
GUMBEL_MARGIN_ULPS = 8
GUMBEL_CLOSE_LIMIT = 1e-3


def fp32_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of fp32 values at each magnitude of ``x`` (float64)."""
    e = torch.floor(torch.log2(x.double().abs().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 23)


def gumbel_plain_z(x, keys, ctx, temperature, floor):
    """The plain version's ``y + g`` (``ops/sampling.py``), whose argmax
    is its token."""
    from apex_tpu_torch.ops import sampling as smp

    y = smp._scaled(x, temperature)
    if floor is not None:
        y = torch.where(y < floor[:, None], smp.NEG_INF, y)
    return y + smp.gumbel_noise(keys, ctx, x.shape[1])


def gumbel_kernels(randn, dev) -> dict:
    """The Gumbel-max sampler (Triton) at a decode step's 4 x 32768 and a
    4-slot k=4 verify's 20 x 32768, fp32, T in {0.7, 1.0}, without a
    floor and with top-k 40 + top-p 0.9, over 256 values of ``ctx``: the
    kernel's token equals the plain version's on every row whose top two
    ``y + g`` differ by more than 8 ulps of the larger; the other rows are
    counted (at most 0.1%); the same bits twice.  Timed at T=1 without a
    floor; bound: the logits read once, and the threefry's integer
    operations at the fp32 rate; no PyTorch call draws JAX's Gumbel
    stream."""
    from apex_tpu_torch.ops import sampling as smp
    from apex_tpu_torch.random import PRNGKey, fold_in, keys_tensor
    from apex_tpu_torch.serving.sampling import _floor

    vocab = FLAGSHIP["vocab_size"]
    records = {"gumbel_argmax": []}
    log(f"[kernels] gumbel_argmax (Triton): rows {GUMBEL_ROWS} x {vocab}, "
        f"fp32, {GUMBEL_CTX} ctx values a case")
    for rows in GUMBEL_ROWS:
        x = randn(rows, vocab, scale=3.0)
        keys = keys_tensor(np.stack([fold_in(PRNGKey(11), r)
                                     for r in range(rows)]), dev)
        base = torch.arange(rows, dtype=torch.int32, device=dev)
        plan = smp.sample_plan(rows, vocab)
        for temperature in (0.7, 1.0):
            for floored in (False, True):
                floor = _floor(x, temperature, 40, 0.9) if floored else None
                close, gap = 0, 0.0
                for j in range(GUMBEL_CTX):
                    ctx = base + 1000 + 37 * j
                    got = smp.gumbel_argmax(x, keys, ctx, temperature, floor)
                    z = gumbel_plain_z(x, keys, ctx, temperature, floor)
                    top2 = z.topk(2, dim=-1).values
                    decisive = (top2[:, 0] - top2[:, 1]).double() > \
                        GUMBEL_MARGIN_ULPS * fp32_ulp(top2[:, 0])
                    want = z.argmax(-1).to(torch.int32)
                    bad = (got != want) & decisive
                    if bool(bad.any()):
                        fail(f"gumbel_argmax rows={rows} T={temperature} "
                             f"floored={floored} ctx+{37 * j}: tokens "
                             f"{got[bad].tolist()} != plain "
                             f"{want[bad].tolist()} on decisive rows")
                    close += int((~decisive).sum())
                    rows_i = torch.arange(rows, device=dev)
                    gap = max(gap, (z[rows_i, want.long()]
                                    - z[rows_i, got.long()]).max().item())
                again = smp.gumbel_argmax(x, keys, ctx, temperature, floor)
                if not torch.equal(again, got):
                    fail(f"gumbel_argmax rows={rows}: two runs differ")
                share = close / (rows * GUMBEL_CTX)
                if share > GUMBEL_CLOSE_LIMIT:
                    fail(f"gumbel_argmax rows={rows} T={temperature}: "
                         f"{close} rows within {GUMBEL_MARGIN_ULPS} ulps "
                         f"({100 * share:.3f}% > "
                         f"{100 * GUMBEL_CLOSE_LIMIT}%)")
                log(f"  rows={rows} (split {plan.split} x {plan.chunk}) "
                    f"T={temperature} "
                    f"{'top-k 40 + top-p 0.9' if floored else 'no floor'}: "
                    f"tokens equal on every decisive row; {close} close "
                    f"rows of {rows * GUMBEL_CTX}; max y+g gap of the "
                    f"kernel's token {gap:.3g}; the same bits twice")
                if temperature != 1.0 or floored:
                    continue
                records["gumbel_argmax"].append(measure(
                    "gumbel_argmax", f"{rows} x {vocab} fp32, T=1",
                    gap, lambda: smp.gumbel_argmax(x, keys, ctx, 1.0),
                    lambda: smp._gumbel_argmax_plain(x, keys, ctx, 1.0,
                                                     None, 0),
                    None, nbytes=rows * vocab * 4 + rows * 16,
                    ops=float(rows * vocab * smp.THREEFRY_OPS),
                    dtype=torch.float32, plain_iters=10))
    return records


def dropout_kernels(randn) -> dict:
    """The hidden-dropout kernel (Triton) at the flagship's activation (8
    x 1024 x 1024), held bit for bit against its plain version, fp32 and
    bf16; then the dropout instances of the seven attention kernels (and
    the short rung's beside segment ids) at :data:`DROP_SHAPES`, fp32 and
    bf16, each against its plain version with the same seed (the backward
    kernels get the plain forward's ``out`` and ``lse``), timed at bf16
    beside the instance without dropout and SDPA with ``dropout_p=0.1``
    (the same work, another mask); then each rung's mask read exactly:
    with q = 0, sk = d and V = I every probability is equal, so out[i, j]
    is non-zero exactly where key j is kept, bit for bit the plain
    hash's."""
    from apex_tpu_torch.ops import attention_short as short
    from apex_tpu_torch.ops import dropout as dr
    from apex_tpu_torch.random import PRNGKey, fold_in
    import torch.nn.functional as F

    records = {}
    key = fold_in(PRNGKey(7), 1)
    log("[kernels] dropout (Triton): the flagship's hidden activation, "
        f"8 x 1024 x 1024, rate {DROP_RATE}")
    for dtype in (torch.float32,) + SM90_DTYPES:
        x = randn(8, 1024, 1024, dtype=dtype)
        got = dr.dropout_fwd(x, key, DROP_RATE)
        want = dr._dropout_plain(x, key, DROP_RATE)
        if not torch.equal(got, want):
            fail(f"dropout {dtype}: {int((got != want).sum())} elements "
                 "differ from the plain version")
        kept = (got != 0).float().mean().item()
        log(f"  dropout {str(dtype)[6:]}: bit-identical to the plain "
            f"version; {kept:.4f} of the elements kept")
        if dtype in SM90_DTYPES:
            # bound: x read once, y written once, or the hash's
            # dr.HASH_OPS 32-bit integer operations an element at the
            # card's 67 T/s of 32-bit operations (as gumbel_argmax's),
            # whichever is longer
            name = f16("dropout", dtype)
            records[name] = [measure(
                name, f"8 x 1024 x 1024 {dtype_name(dtype)}", 0.0,
                lambda: dr.dropout_fwd(x, key, DROP_RATE),
                lambda: dr._dropout_plain(x, key, DROP_RATE),
                ("F.dropout", lambda: F.dropout(x, DROP_RATE, training=True)),
                nbytes=2 * x.numel() * x.element_size(),
                ops=float(dr.HASH_OPS) * x.numel(), dtype=torch.float32,
                plain_iters=10)]
    drop = (DROP_RATE, DROP_SEED)
    log(f"[kernels] attention dropout instances (CUDA), rate {DROP_RATE}, "
        f"seed {DROP_SEED:#x}")
    for rung, b, heads, s, d, causal, kind, timed_names in DROP_SHAPES:
        for dtype in (torch.float32,) + SM90_DTYPES:
            if dtype == torch.float16 and not timed_names:
                continue
            q, k, v, dout = (randn(b, heads, s, d, dtype=dtype)
                             for _ in range(4))
            ids = (segment_ids(kind, b, s, q.device, seed=s + b) if kind
                   else (None, None))
            run = variant_run(rung, q, k, v, dout, causal, ids, drop)
            errs = {}
            for name, label, got, want in run["checks"]:
                errs[name] = max(errs.get(name, 0.0),
                                 check(name, got, want,
                                       f"{str(dtype)[6:]} b={b} h={heads} "
                                       f"s={s} d={d} {label}"))
            if dtype in SM90_DTYPES:
                records.update(variant_records(
                    rung, b, heads, s, d, causal, kind, q, k, v, dout, ids,
                    drop, run, errs, tuple(f16(n, dtype)
                                           for n in timed_names)))
    drop_masks(randn)
    return records


def variant_run(rung, q, k, v, dout, causal, ids, drop, bias=None):
    """One rung's dropout or bias instances on ``(b, h, sq, d)`` inputs
    against the plain versions: ``{"checks": [(counter, output, kernel's,
    plain's)], "calls": {counter: (the instance, the same call without the
    bias, or without the dropout when there is no bias)}, "plain":
    {counter: plain version}}`` (the backward calls take the plain
    forward's ``out`` and ``lse``).  With a bias the lse is checked on the
    rows it leaves alone: a row it hides (:data:`BIAS_MASKED_ROWS`) has an
    lse of about -1e30 + log n."""
    from apex_tpu_torch.ops import attention_flash as fl
    from apex_tpu_torch.ops import attention_mid as mid
    from apex_tpu_torch.ops import attention_short as short

    b, heads, sq, d = q.shape
    sk = k.shape[2]
    scale = d ** -0.5
    qi, ki = ids
    slab = short.bias_slab("bias", bias, b, heads, sq, sk)
    kw = dict(q_segment_ids=qi, kv_segment_ids=ki)
    if drop:
        kw.update(dropout_rate=drop[0], dropout_seed=drop[1])
    # the call the instance is timed against: without the bias, or
    # without the dropout
    base = dict(kw) if bias is not None else dict(
        q_segment_ids=qi, kv_segment_ids=ki)
    tag = short.counter(("", "_seg"), qi is not None, drop, slab,
                        half=q.dtype == torch.float16)
    run = {}
    if rung == "flash":
        flat = [t.reshape(b * heads, -1, d) for t in (q, k, v, dout)]
        kw["heads"] = base["heads"] = heads
        out, lse = fl._flash_fwd_plain(*flat[:3], causal, scale, qi, ki,
                                       heads, drop, slab)
        delta = fl.flash_delta(out, flat[3])
        entries = (
            lambda bb, a: fl.flash_fwd(*flat[:3], causal, **a, bias=bb),
            lambda bb, a: fl.flash_bwd_dkv(*flat, lse, delta, causal, **a,
                                           bias=bb),
            lambda bb, a: fl.flash_bwd_dq(*flat, lse, delta, causal, **a,
                                          bias=bb))
        got, got_lse = entries[0](bias, kw)
        gk, gv = entries[1](bias, kw)
        gq = entries[2](bias, kw)
        wq, wk, wv = fl._flash_bwd_plain(*flat, lse, delta, causal, scale,
                                         qi, ki, heads, drop, slab)
        names = ("flash_fwd" + tag, "flash_bwd_dkv" + tag,
                 "flash_bwd_dq" + tag)
        run["checks"] = [(names[0], "out", got.view_as(q), out.view_as(q)),
                         (names[0], "lse", got_lse, lse),
                         (names[2], "dq", gq, wq), (names[1], "dk", gk, wk),
                         (names[1], "dv", gv, wv)]
        run["calls"] = {n: (lambda f=f: f(bias, kw), lambda f=f: f(None, base))
                        for n, f in zip(names, entries)}
        plain_bwd = lambda: fl._flash_bwd_plain(
            *flat, lse, delta, causal, scale, qi, ki, heads, drop, slab)
        run["plain"] = {
            names[0]: lambda: fl._flash_fwd_plain(
                *flat[:3], causal, scale, qi, ki, heads, drop, slab),
            names[1]: plain_bwd, names[2]: plain_bwd}
    else:
        fwd, bwd = ((short.short_fwd, short.short_bwd) if rung == "short"
                    else (mid.mid_fwd, mid.mid_bwd))
        out, lse = short._short_fwd_plain(q, k, v, causal, scale, qi, ki,
                                          drop, slab)
        got, got_lse = fwd(q, k, v, causal, **kw, bias=bias)
        wq, wk, wv = short._short_bwd_plain(q, k, v, out, dout, lse, None,
                                            causal, scale, qi, ki, drop,
                                            slab)
        gq, gk, gv = bwd(q, k, v, out, dout, lse, None, causal, **kw,
                         bias=bias)
        names = (f"{rung}_fwd" + tag, f"{rung}_bwd" + tag)
        run["checks"] = [(names[0], "out", got, out),
                         (names[0], "lse", got_lse, lse),
                         (names[1], "dq", gq, wq), (names[1], "dk", gk, wk),
                         (names[1], "dv", gv, wv)]
        run["calls"] = {
            names[0]: (lambda: fwd(q, k, v, causal, **kw, bias=bias),
                       lambda: fwd(q, k, v, causal, **base)),
            names[1]: (lambda: bwd(q, k, v, out, dout, lse, None, causal,
                                   **kw, bias=bias),
                       lambda: bwd(q, k, v, out, dout, lse, None, causal,
                                   **base))}
        run["plain"] = {
            names[0]: lambda: short._short_fwd_plain(
                q, k, v, causal, scale, qi, ki, drop, slab),
            names[1]: lambda: short._short_bwd_plain(
                q, k, v, out, dout, lse, None, causal, scale, qi, ki, drop,
                slab)}
    if bias is not None:
        keep = torch.ones(sq, dtype=torch.bool, device=q.device)
        keep[list(BIAS_MASKED_ROWS)] = False
        name, _, got_lse, want_lse = run["checks"][1]
        run["checks"][1] = (name, "lse (rows not hidden)",
                            got_lse.view(b, heads, sq)[..., keep],
                            want_lse.view(b, heads, sq)[..., keep])
    return run


def bias_read_bytes(slab: torch.Tensor, visible) -> int:
    """The bytes of a :func:`bias_slab` tensor ``(nb, nh, sq, sk)`` fp32
    that the function must read: an element once if some (query, key)
    pair it is added to is visible (``visible`` broadcastable to ``(b, h,
    sq, sk)``, None: every pair).  A causal row needs only the lower
    triangle; ids that hide a pair in every batch row hide its element of
    a shared bias."""
    if visible is None:
        return slab.numel() * 4
    nb, nh, sq, sk = slab.shape
    vis = visible.reshape((1,) * (4 - visible.ndim) + tuple(visible.shape))
    for dim, n in ((0, nb), (1, nh)):
        if vis.shape[dim] > n:      # pairs a broadcast element serves
            vis = vis.any(dim, keepdim=True)
    return int(vis.expand(nb, nh, sq, sk).sum().item()) * 4


def variant_records(rung, b, heads, s, d, causal, kind, q, k, v, dout, ids,
                    drop, run, errs, timed_names, bias=None) -> dict:
    """Time the dropout or bias instances named ``timed_names`` (bf16)
    beside the same kernel without the bias (without the dropout when
    there is no bias), the plain version and SDPA with the same mask: a
    float ``attn_mask`` for a bias, ``dropout_p`` for dropout (the same
    work, another mask); forward, or forward and backward through
    autograd, profiled, for a backward kernel.  The bound is the
    instance's row's without dropout or bias (the hash's integer
    operations have no rate in the table) plus the bias elements the
    function must read, each once (:func:`bias_read_bytes`)."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import attention_short as short

    qi, ki = ids
    p = 0.0 if drop is None else drop[0]
    visible = None if qi is None else (qi[:, :, None] == ki[:, None, :])[:,
                                                                         None]
    if bias is not None:
        if causal:
            tril = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
            visible = tril if visible is None else visible & tril
        mask = bias if visible is None else bias.masked_fill(
            ~visible, float("-inf"))
        sdpa_kw = dict(attn_mask=mask.to(q.dtype))
        bias_bytes = bias_read_bytes(
            short.bias_slab("bias", bias, b, heads, s, s), visible)
    else:
        sdpa_kw = dict(is_causal=True) if causal else dict(attn_mask=visible)
        bias_bytes = 0
    pairs = (heads * seg_pairs(qi, ki) if qi is not None
             else b * heads * s * (s + 1) / 2 if causal
             else b * heads * s * s)
    numel = q.numel() * q.element_size()
    rows = b * heads * s * 4
    id_bytes = 0 if qi is None else 2 * qi.numel() * 4
    shape = (f"b={b} h={heads} s={s} d={d}"
             + (f" {kind} bias" if bias is not None else "")
             + (" causal" if causal else "")
             + (f" {kind} ids" if qi is not None and bias is None else "")
             + (" ids" if qi is not None and bias is not None else "")
             + (" dropout" if drop and bias is not None else "")
             + f" {dtype_name(q.dtype)}")
    without = "bias" if bias is not None else "dropout"
    label = ("SDPA" + (" (float mask)" if bias is not None else "")
             + (f" dropout_p={p}" if p else ""))
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, dropout_p=p,
                                           **sdpa_kw)
        torch.autograd.grad(o, (qg, kg, vg), dout)

    fb_ms = None
    iters = 10 if rung == "flash" else 50
    recs = {}
    for name in timed_names:
        kernel, base = run["calls"][name]
        fwd = "_fwd" in name
        if fwd:
            library = (label, lambda: F.scaled_dot_product_attention(
                q, k, v, dropout_p=p, **sdpa_kw))
            nbytes, ops = 4 * numel + rows + id_bytes, 4.0 * d * pairs
        else:
            library = None
            if rung == "flash":
                n_out, n_prod = (2, 4) if "dkv" in name else (1, 3)
                nbytes = (4 + n_out) * numel + 2 * rows + id_bytes
                ops = 2.0 * n_prod * d * pairs
            else:
                nbytes, ops = 8 * numel + rows + id_bytes, 10.0 * d * pairs
        rec = measure(name, shape, errs[name], kernel, run["plain"][name],
                      library, nbytes=nbytes + bias_bytes, ops=ops,
                      dtype=q.dtype, plain_iters=iters)
        if not fwd:
            if fb_ms is None:
                fb_ms = profiled_ms(sdpa_fwd_bwd)
            rec["library_ms"] = fb_ms
            log(f"  {name}: library call is {label} forward+backward "
                f"({fb_ms:.4f} ms of device time, profiler), which includes "
                "a forward")
        base_ms, _ = time_ms(base, iters)
        log(f"  {name}: {rec['ms'] / base_ms:.3f}x the same kernel without "
            f"the {without} ({base_ms:.4f} ms) at this shape")
        rec[f"ms_without_{without}"] = base_ms
        recs[name] = [rec]
    return recs


#: the ragged cases of the bf16 forward (attention_fwd_sm90.cuh), each at
#: d = 64 and 128 and with all eight combinations of segment ids, dropout
#: and a bias: (rung, b, h, sq, sk, causal); the short rung's window is
#: 512 tokens, so its cases are the same raggedness below it
FWD_SM90_CASES = (("short", 2, 2, 500, 500, False),
                  ("short", 2, 2, 300, 470, True),
                  ("mid", 2, 2, 1000, 1000, False),
                  ("mid", 2, 2, 700, 1100, True),
                  ("flash", 2, 2, 1000, 1000, False),
                  ("flash", 2, 2, 700, 1100, True))
#: a query row whose id no key has (it sees no key: out 0, lse ~-1e30)
FWD_SM90_LONELY_ROW = 3


def fwd_sm90_kernels(randn, dev) -> None:
    """Every bf16 and fp16 instance of the short, mid and flash forwards
    (the wgmma/TMA kernel: d = 64 and 128, segment ids x dropout x bias)
    at ragged shapes, against its plain version on the same inputs and for
    the same bits on a second call: out within two ulps of the type, lse
    within
    1e-3 where the row sees a key and about -1e30 where it sees none.
    The ids are blocks of 150 positions, with query row
    :data:`FWD_SM90_LONELY_ROW` at an id no key has; the bias is per
    (batch, head) with the rows of :data:`BIAS_MASKED_ROWS` hidden, whose
    output is the uniform mean of V over the keys they see."""
    for dtype in SM90_DTYPES:
        fwd_sm90_dtype(randn, dev, dtype)


def fwd_sm90_dtype(randn, dev, dtype) -> None:
    from apex_tpu_torch.ops import attention_flash as fl
    from apex_tpu_torch.ops import attention_mid as mid
    from apex_tpu_torch.ops import attention_short as short

    log(f"[kernels] {dtype_name(dtype)} forwards (attention_fwd_sm90.cuh): "
        "every instance at ragged shapes")
    entries = {"short": short.short_fwd, "mid": mid.mid_fwd}
    worst, n = {}, 0
    for rung, b, heads, sq, sk, causal in FWD_SM90_CASES:
        for d in (64, 128):
            q = randn(b, heads, sq, d, dtype=dtype)
            k = randn(b, heads, sk, d, dtype=dtype)
            v = randn(b, heads, sk, d, dtype=dtype)
            ki = (torch.arange(sk, device=dev) // 150).int().expand(b, sk)
            qi = (torch.arange(sq, device=dev) // 150).int().expand(
                b, sq).contiguous()
            qi[:, FWD_SM90_LONELY_ROW] = -1
            ki = ki.contiguous()
            bias = randn(b, heads, sq, sk)
            bias[..., list(BIAS_MASKED_ROWS), :] = -1e30
            for segs in (False, True):
                for drop in (None, (DROP_RATE, DROP_SEED)):
                    for biased in (False, True):
                        ids = (qi, ki) if segs else (None, None)
                        bb = bias if biased else None
                        slab = short.bias_slab("bias", bb, b, heads, sq, sk)
                        kw = dict(q_segment_ids=ids[0], kv_segment_ids=ids[1])
                        if drop:
                            kw.update(dropout_rate=drop[0],
                                      dropout_seed=drop[1])
                        scale = d ** -0.5
                        if rung == "flash":
                            flat = [t.reshape(b * heads, -1, d)
                                    for t in (q, k, v)]
                            call = lambda: fl.flash_fwd(
                                *flat, causal, **kw, heads=heads, bias=bb)
                            want, want_lse = fl._flash_fwd_plain(
                                *flat, causal, scale, *ids, heads, drop,
                                slab)
                        else:
                            call = lambda: entries[rung](q, k, v, causal,
                                                         **kw, bias=bb)
                            want, want_lse = short._short_fwd_plain(
                                q, k, v, causal, scale, *ids, drop, slab)
                        got, got_lse = call()
                        again, again_lse = call()
                        name = (f"{rung}_fwd" + short.counter(
                            ("", "_seg"), segs, drop, slab,
                            half=dtype == torch.float16))
                        what = (f"{dtype_name(dtype)} d={d} b={b} h={heads} "
                                f"sq={sq} sk={sk}"
                                f"{' causal' if causal else ''}")
                        if not (torch.equal(got, again)
                                and torch.equal(got_lse, again_lse)):
                            fail(f"{name} {what}: a second call gave other "
                                 "bits")
                        err = max_err(got.view_as(want), want)
                        tol = tolerance(want)
                        seen = want_lse > -1e29
                        lse_err = max_err(got_lse.view_as(want_lse)[seen],
                                          want_lse[seen])
                        unseen = got_lse.view_as(want_lse)[~seen]
                        top = unseen.max().item() if unseen.numel() else -1e30
                        if not (err <= tol and lse_err <= 1e-3
                                and top <= -1e29):
                            fail(f"{name} {what}: out error {err:.3g} "
                                 f"(tolerance {tol:.3g}), lse error "
                                 f"{lse_err:.3g} (1e-3), rows that see no "
                                 f"key: lse up to {top:.3g}")
                        worst[name] = max(worst.get(name, 0.0), err / tol)
                        n += 1
    log(f"  {n} instance cases held, the same bits twice; the worst out "
        "error a counter, as a share of its tolerance: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(worst.items())))


#: the ragged cases of the bf16 backward (attention_bwd_sm90.cuh): the
#: forward's cases, and one a rung whose sq is no multiple of 4 (a (bh, sq)
#: row of lse then starts off a 16-byte boundary) and sk odd (no bias or
#: dBias row is 8-byte aligned), the flash one causal past 4096 tokens (a
#: block walks 64 tiles, wrapping the ring of stages 21-32 times); the mid
#: ones take a real lse cotangent
BWD_SM90_CASES = FWD_SM90_CASES + (
    ("short", 2, 2, 250, 331, True), ("mid", 2, 2, 777, 1001, False),
    ("flash", 1, 2, 4098, 4131, True))


def bwd_sm90_calls(rung, b, heads, q, k, v, dout, dlse, causal, ids, drop,
                   slab, bias, grad):
    """``(call, want)`` of one bf16 backward instance case: ``call()``
    runs the rung's entries on the card (short/mid: one call; flash:
    ``flash_bwd_dkv`` and ``flash_bwd_dq`` on the flattened ``(b*h, s,
    d)`` operands with ``heads=`` and ``delta = flash_delta(out, dout)``)
    and gives ``(dq, dk, dv[, dbias])``; ``want`` is its plain version's,
    fed the plain forward's ``out`` and ``lse``, dBias folded into the
    bias's shape."""
    from apex_tpu_torch.ops import attention_flash as fl
    from apex_tpu_torch.ops import attention_mid as mid
    from apex_tpu_torch.ops import attention_short as short

    scale = q.shape[-1] ** -0.5
    kw = dict(q_segment_ids=ids[0], kv_segment_ids=ids[1], bias=bias)
    if drop:
        kw.update(dropout_rate=drop[0], dropout_seed=drop[1])
    if rung == "flash":
        flat = [t.reshape(b * heads, -1, t.shape[-1])
                for t in (q, k, v, dout)]
        out, lse = fl._flash_fwd_plain(*flat[:3], causal, scale, *ids, heads,
                                       drop, slab)
        delta = fl.flash_delta(out, flat[3])

        def call():
            dk, dv = fl.flash_bwd_dkv(*flat, lse, delta, causal, **kw,
                                      heads=heads)
            dq = fl.flash_bwd_dq(*flat, lse, delta, causal, **kw,
                                 heads=heads, bias_grad=grad)
            return (dq[0], dk, dv, dq[1]) if grad else (dq, dk, dv)
        want = fl._flash_bwd_plain(*flat, lse, delta, causal, scale, *ids,
                                   heads, drop, slab, grad)
        dz = want[3].view(b, heads, *want[3].shape[1:]) if grad else None
    else:
        entry = {"short": short.short_bwd, "mid": mid.mid_bwd}[rung]
        out, lse = short._short_fwd_plain(q, k, v, causal, scale, *ids, drop,
                                          slab)
        call = lambda: entry(q, k, v, out, dout, lse, dlse, causal, **kw,
                             bias_grad=grad)
        want = short._short_bwd_plain(q, k, v, out, dout, lse, dlse, causal,
                                      scale, *ids, drop, slab, grad)
        dz = want[3] if grad else None
    if grad:
        want = want[:3] + (short.fold_bias_grad(dz, bias.shape,
                                                bias.dtype),)
    return call, want


def bwd_sm90_kernels(randn, dev) -> None:
    """Every bf16 and fp16 instance of the short, mid and flash backwards
    (the wgmma/TMA kernels of attention_bwd_sm90.cuh: d = 64 and 128, segment
    ids x dropout x bias, and beside each bias the dQ kernel's dBias
    instance) at :data:`BWD_SM90_CASES`, fed the plain forward's ``out``
    and ``lse`` and held against ``_short_bwd_plain`` (flash:
    ``_flash_bwd_plain``, :func:`bwd_sm90_calls`) on the same inputs and
    for the same bits on a second call: dq, dk and dv within two ulps of
    the type at their largest magnitude (:func:`tolerance`, as every backward check
    of phase 2), a dBias element by element within :func:`dbias_band`.
    The ids, the lonely query row (:data:`FWD_SM90_LONELY_ROW`, which sees
    no key) and the bias with its hidden rows are those of
    :func:`fwd_sm90_kernels`; the mid cases take a real ``dlse``."""
    for dtype in SM90_DTYPES:
        bwd_sm90_dtype(randn, dev, dtype)


def bwd_sm90_dtype(randn, dev, dtype) -> None:
    from apex_tpu_torch.ops import attention_short as short

    log(f"[kernels] {dtype_name(dtype)} backwards (attention_bwd_sm90.cuh): "
        "every instance at ragged shapes")
    half = dtype == torch.float16
    worst, band, n = {}, 0.0, 0
    for rung, b, heads, sq, sk, causal in BWD_SM90_CASES:
        for d in (64, 128):
            q, dout = (randn(b, heads, sq, d, dtype=dtype)
                       for _ in range(2))
            k, v = (randn(b, heads, sk, d, dtype=dtype)
                    for _ in range(2))
            ki = (torch.arange(sk, device=dev) // 150).int().expand(
                b, sk).contiguous()
            qi = (torch.arange(sq, device=dev) // 150).int().expand(
                b, sq).contiguous()
            qi[:, FWD_SM90_LONELY_ROW] = -1
            bias = randn(b, heads, sq, sk)
            bias[..., list(BIAS_MASKED_ROWS), :] = -1e30
            dlse = randn(b, heads, sq) if rung == "mid" else None
            for segs in (False, True):
                for drop in (None, (DROP_RATE, DROP_SEED)):
                    for biased in (False, True):
                        ids = (qi, ki) if segs else (None, None)
                        bb = bias if biased else None
                        slab = short.bias_slab("bias", bb, b, heads, sq, sk)
                        for grad in (False, True) if biased else (False,):
                            call, want = bwd_sm90_calls(
                                rung, b, heads, q, k, v, dout, dlse, causal,
                                ids, drop, slab, bb, grad)
                            got, again = call(), call()
                            suffix = short.counter(("", "_seg"), segs, drop,
                                                   slab, grad, half)
                            names = ((f"{rung}_bwd{suffix}",) * 3
                                     if rung != "flash" else
                                     (f"flash_bwd_dq{suffix}",) + (
                                         "flash_bwd_dkv" + short.counter(
                                             ("", "_seg"), segs, drop,
                                             slab, half=half),) * 2)
                            what = (f"{dtype_name(dtype)} d={d} b={b} "
                                    f"h={heads} sq={sq} "
                                    f"sk={sk}{' causal' if causal else ''}"
                                    f"{' dlse' if dlse is not None else ''}")
                            if not all(torch.equal(g, a)
                                       for g, a in zip(got, again)):
                                fail(f"{names[0]} {what}: a second call gave"
                                     " other bits")
                            for name, label, g, w in zip(
                                    names, ("dq", "dk", "dv"), got, want):
                                err, tol = max_err(g, w), tolerance(w)
                                if not err <= tol:
                                    fail(f"{name} {what} {label}: max |kernel"
                                         f" - plain| = {err:.3g} > tolerance "
                                         f"{tol:.3g}")
                                worst[name] = max(worst.get(name, 0.0),
                                                  err / tol)
                            if grad:
                                band = max(band, dbias_check(
                                    f"{names[0]} {what}", got[3], want[3])[1])
                            n += 1
            del q, k, v, dout, bias
    log(f"  {n} instance cases held, the same bits twice; the worst dq/dk/dv"
        " error a counter, as a share of its tolerance: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(worst.items()))
        + f"; dBias at most {band:.3f} of its band")


def drop_masks(randn) -> None:
    """Each rung's keep mask read from the kernel, bit for bit: q = 0
    makes every score 0 (every p equal), sk = d keys and V = I make
    out[i, j] = keep(i, j) / (1 - rate) / sk, so the output is non-zero
    exactly where the kernel kept key j for query i.  b=2 h=4 (eight
    global batch*head rows), 300 queries (five 64-row tiles), not
    causal, fp32 and bf16, d=128."""
    from apex_tpu_torch.ops import attention_flash as fl
    from apex_tpu_torch.ops import attention_mid as mid
    from apex_tpu_torch.ops import attention_short as short

    b, heads, sq, d = 2, 4, 300, 128
    kw = dict(dropout_rate=DROP_RATE, dropout_seed=DROP_SEED)
    want = short.keep_rows((DROP_RATE, DROP_SEED), (b, heads), sq, d,
                           torch.device("cuda", 0))
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros(b, heads, sq, d, dtype=dtype, device=want.device)
        k = randn(b, heads, d, d, dtype=dtype)
        v = torch.eye(d, dtype=dtype, device=want.device).expand(
            b, heads, d, d).contiguous()
        outs = {
            "short": short.short_fwd(q, k, v, False, 1.0, **kw)[0],
            "mid": mid.mid_fwd(q, k, v, False, 1.0, **kw)[0],
            "flash": fl.flash_fwd(*(t.reshape(b * heads, -1, d)
                                    for t in (q, k, v)), False, 1.0,
                                  **kw)[0].view(b, heads, sq, d)}
        for rung, out in outs.items():
            seen = out != 0
            if not torch.equal(seen, want):
                fail(f"{rung} dropout mask ({dtype}): "
                     f"{int((seen != want).sum())} of {want.numel()} keep "
                     "decisions differ from the plain hash")
        log(f"  V = I, {str(dtype)[6:]}: the short, mid and flash kernels' "
            f"masks equal the plain hash bit for bit ({want.numel()} "
            f"decisions, {want.float().mean().item():.4f} kept)")


# ---------------------------------------------------------------- phase 3
def serve(model, requests, max_prompt_len, page_size, max_seqs,
          pages_per_seq, harvest_every=8, weight_dtype=None, kv_dtype=None,
          eager=False, sampling=None):
    """Serve ``requests`` through ``decode_fns`` (``weight_dtype``,
    ``sampling``: its temperature/top-k/top-p, server key ``PRNGKey(0)``)
    over a fresh paged cache (``kv_dtype``) and ``ContinuousBatcher``,
    after one untimed 3-token request on the same batcher (the decode
    step's warm-up and graph capture at its shape); ``eager`` drives
    ``decode_eager`` in place of the replayed step.  Returns
    ``(completions, wall s, [prefill s], batcher)``."""
    from apex_tpu_torch.random import PRNGKey
    from apex_tpu_torch.serving import (
        ContinuousBatcher, KVCacheConfig, PagedKVCache, Request, init_pools)

    c = model.config
    ccfg = KVCacheConfig(
        num_layers=c.num_layers, num_heads=c.num_attention_heads,
        head_dim=c.head_dim, num_pages=1 + max_seqs * pages_per_seq,
        page_size=page_size, max_seqs=max_seqs,
        pages_per_seq=pages_per_seq, dtype=c.compute_dtype,
        kv_dtype=kv_dtype)
    fns = model.decode_fns(ccfg, max_prompt_len=max_prompt_len,
                           weight_dtype=weight_dtype, **(sampling or {}))
    prefill_s = []

    def timed_prefill(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fns.prefill(*args)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        return out

    batcher = ContinuousBatcher(
        timed_prefill, fns.decode_eager if eager else fns.decode,
        PagedKVCache(ccfg), init_pools(ccfg, model.device),
        max_prompt_len=max_prompt_len, harvest_every=harvest_every,
        key=PRNGKey(0))
    batcher.run([Request(uid="warm", prompt=[1, 2, 3], max_new_tokens=3)])
    batcher.completions.clear()
    batcher.steps = batcher.windows = 0
    prefill_s.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comps = batcher.run(requests)
    torch.cuda.synchronize()
    return comps, time.perf_counter() - t0, prefill_s, batcher


def phase_parity(dev) -> None:
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.serving import Request

    log("[parity] flagship width, 2 layers, fp32: paged greedy vs "
        "full recompute")
    cfg = GPTConfig(**dict(FLAGSHIP, num_layers=2),
                    compute_dtype=torch.float32)
    model = GPTModel(cfg, device=dev, seed=1)
    rng = np.random.RandomState(2)
    plens = np.array([48, 17, 64, 5, 33, 60])
    prompts = rng.randint(1, cfg.vocab_size, (6, 64)).astype(np.int32)
    for i, n in enumerate(plens):
        prompts[i, n:] = 0
    new = 16
    ref = model.generate_reference(prompts, plens, new)
    reqs = [Request(uid=i, prompt=prompts[i, :n].tolist(),
                    max_new_tokens=new) for i, n in enumerate(plens)]
    comps, _, _, _ = serve(model, reqs, max_prompt_len=64, page_size=16,
                           max_seqs=2, pages_per_seq=5, harvest_every=4)
    for i in range(6):
        if comps[i].tokens != ref[i].tolist():
            fail(f"parity: request {i} paged {comps[i].tokens} != "
                 f"reference {ref[i].tolist()}")
    distinct = len({t for r in ref.tolist() for t in r})
    log(f"  6 requests x {new} tokens identical ({distinct} distinct ids)")
    # one prompt past the short rung: monolithic prefill through mid_fwd
    long_prompt = rng.randint(1, cfg.vocab_size, (1, 600)).astype(np.int32)
    ref = model.generate_reference(long_prompt, [600], new)
    comps, _, _, _ = serve(
        model, [Request(uid="long", prompt=long_prompt[0].tolist(),
                        max_new_tokens=new)],
        max_prompt_len=640, page_size=16, max_seqs=1, pages_per_seq=41)
    if comps["long"].tokens != ref[0].tolist():
        fail(f"parity: 600-token prompt paged {comps['long'].tokens} != "
             f"reference {ref[0].tolist()}")
    log(f"  a 600-token prompt (prefill padded to 640, mid rung): {new} "
        "tokens identical")
    del model
    torch.cuda.empty_cache()


def phase_rope_parity(dev) -> dict:
    """The Llama-mode GPT at the flagship's width, 2 layers, fp32: four
    requests of 2500, 300, 1200 and 50 tokens through 2 slots (prefill
    padded to 2560, the flash rung; decode through the fused q-RoPE) must
    give ``generate_reference``'s tokens.  Returns the launches."""
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import Request

    log("[rope-parity] Llama-mode width, 2 layers, fp32: paged greedy vs "
        "full recompute, prompts up to 2500 tokens")
    cfg = GPTConfig(**dict(LLAMA, num_layers=2), compute_dtype=torch.float32)
    model = GPTModel(cfg, device=dev, seed=4)
    rng = np.random.RandomState(5)
    plens = np.array([2500, 300, 1200, 50])
    prompts = rng.randint(1, cfg.vocab_size, (4, 2500)).astype(np.int32)
    for i, n in enumerate(plens):
        prompts[i, n:] = 0
    new = 16
    ref = model.generate_reference(prompts, plens, new)
    reqs = [Request(uid=i, prompt=prompts[i, :n].tolist(),
                    max_new_tokens=new) for i, n in enumerate(plens)]
    torch.cuda.synchronize()
    reset_launch_counts()
    comps, _, _, _ = serve(model, reqs, max_prompt_len=2560, page_size=64,
                           max_seqs=2, pages_per_seq=41, harvest_every=4)
    torch.cuda.synchronize()
    counts = launch_counts()
    for i in range(4):
        if comps[i].tokens != ref[i].tolist():
            fail(f"rope-parity: request {i} ({plens[i]} tokens) paged "
                 f"{comps[i].tokens} != reference {ref[i].tolist()}")
    distinct = len({t for r in ref.tolist() for t in r})
    log(f"  4 requests x {new} tokens identical ({distinct} distinct ids); "
        f"launches {counts}")
    for name in ("flash_fwd", "paged_decode"):
        if counts.get(name, 0) <= 0:
            fail(f"rope-parity: kernel {name} never launched")
    del model
    torch.cuda.empty_cache()
    return counts


def kv_logit_band(model, prompts, plens, steps: int, page_size: int = 16,
                  chunk=None):
    """Decode logits from int8 KV pages against the same model's
    full-precision pages: both caches take the same prompts (in one
    prefill, or in ``chunk``-token chunks), then the same tokens (the
    full-precision path's greedy picks) for ``steps`` decode steps.
    Returns ``(max |diff|, share of positions whose argmax agrees,
    largest |logit|)``."""
    from apex_tpu_torch.serving import KVCacheConfig, PagedKVCache, init_pools

    c, dev = model.config, model.device
    S, width = prompts.shape
    pps = -(-(width + steps) // page_size)
    runs = []
    for kv_dtype in (None, torch.int8):
        ccfg = KVCacheConfig(
            num_layers=c.num_layers, num_heads=c.num_attention_heads,
            head_dim=c.head_dim, num_pages=1 + S * pps, page_size=page_size,
            max_seqs=S, pages_per_seq=pps, dtype=c.compute_dtype,
            kv_dtype=kv_dtype)
        cache, pools = PagedKVCache(ccfg), init_pools(ccfg, dev)
        fns = model.decode_fns(ccfg, max_prompt_len=width,
                               prefill_chunk=chunk)
        firsts = []
        for i in range(S):
            n = int(plens[i])
            cache.admit(i, n + steps)
            row = torch.as_tensor(cache.page_table[i], device=dev)
            if chunk is None:
                pools, first = fns.prefill(
                    pools, torch.as_tensor(prompts[i:i + 1], device=dev), n,
                    row)
            for c0 in range(0, n if chunk else 0, chunk or 1):
                toks = np.zeros(chunk, np.int32)
                seg = prompts[i, c0:c0 + chunk]
                toks[:len(seg)] = seg
                pools, first, _ = fns.chunk(pools, toks, c0, n, 0, row)
            firsts.append(first)
        table = torch.as_tensor(cache.page_table, device=dev)
        runs.append((ccfg, table, pools, torch.stack(firsts)))
    tokens = runs[0][3].to(torch.int32)
    positions = torch.as_tensor(np.asarray(plens), dtype=torch.int32,
                                device=dev)
    active = torch.ones(S, dtype=torch.bool, device=dev)
    band, scale, agree = 0.0, 0.0, []
    with torch.no_grad():
        for _ in range(steps):
            hi, lo = (model.decode_step(
                tokens, positions, active, table, pools,
                quantized=ccfg.quantized, kv_block=ccfg.kv_block)[0].float()
                for ccfg, table, pools, _ in runs)
            band = max(band, (lo - hi).abs().max().item())
            scale = max(scale, hi.abs().max().item())
            agree.append((lo.argmax(-1) == hi.argmax(-1)).float().mean()
                         .item())
            tokens = hi.argmax(-1).to(torch.int32)
            positions = positions + 1
    return band, float(np.mean(agree)), scale


#: int8 KV pages against fp32 pages in quant-parity: the decode logits'
#: band as a share of the largest |logit|, and the least share of
#: positions whose argmax agrees.  An int8 row keeps each value to half
#: of 1/127 of its block's largest; the readings were 0.4% of the logit
#: scale and 100% agreement, so 2% leaves room while a wrong scale slice
#: or block (errors on the logit scale itself) fails, and 98% lets one
#: of the 96 positions flip on a near-tie.
KV_BAND_MAX = 0.02
KV_AGREE_MIN = 0.98


def phase_quant_parity(dev) -> None:
    """Quantized serving at the flagship's width, 2 layers, fp32 compute,
    phase 3's 6 ragged requests through 2 slots, 16 new tokens: from int8
    and int4 weight pools (the flagship) and int4 (the Llama mode, with
    its ``fc_gate``), the paged greedy tokens must equal
    ``generate_reference`` on the same quantized model, both through the
    dequant kernels; from int8 KV pages (fp32 weights) every request must
    complete, and the decode logits are held against fp32 pages."""
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.models.gpt import quantize_gpt_weights
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import Request

    log("[quant-parity] 2 layers at the flagship's width, fp32: paged "
        "greedy from quantized pools vs full recompute on the same pools")
    new = 16
    plens = np.array([48, 17, 64, 5, 33, 60])
    rng = np.random.RandomState(2)
    for label, sizes, widths in (("flagship", FLAGSHIP, ("int8", "int4")),
                                 ("Llama mode", LLAMA, ("int4",))):
        cfg = GPTConfig(**dict(sizes, num_layers=2),
                        compute_dtype=torch.float32)
        model = GPTModel(cfg, device=dev, seed=1)
        prompts = rng.randint(1, cfg.vocab_size, (6, 64)).astype(np.int32)
        for i, n in enumerate(plens):
            prompts[i, n:] = 0
        reqs = [Request(uid=i, prompt=prompts[i, :n].tolist(),
                        max_new_tokens=new) for i, n in enumerate(plens)]
        for wd in widths:
            qm = quantize_gpt_weights(model, wd)
            ref = qm.generate_reference(prompts, plens, new)
            torch.cuda.synchronize()
            reset_launch_counts()
            comps, _, _, _ = serve(qm, reqs, max_prompt_len=64, page_size=16,
                                   max_seqs=2, pages_per_seq=5,
                                   harvest_every=4)
            torch.cuda.synchronize()
            counts = launch_counts()
            for i in range(6):
                if comps[i].tokens != ref[i].tolist():
                    fail(f"quant-parity: {label} {wd} request {i} paged "
                         f"{comps[i].tokens} != reference "
                         f"{ref[i].tolist()}")
            if counts.get(f"dequant_{wd}", 0) <= 0:
                fail(f"quant-parity: dequant_{wd} never launched")
            distinct = len({t for r in ref.tolist() for t in r})
            log(f"  {label}, {wd} weights: 6 requests x {new} tokens "
                f"identical ({distinct} distinct ids); launches {counts}")
        if label != "flagship":
            continue
        reset_launch_counts()
        comps, _, _, _ = serve(model, reqs, max_prompt_len=64, page_size=16,
                               max_seqs=2, pages_per_seq=5, harvest_every=4,
                               kv_dtype=torch.int8)
        torch.cuda.synchronize()
        counts = launch_counts()
        for i in range(6):
            toks = comps[i].tokens
            if len(toks) != new or not all(0 <= t < cfg.vocab_size
                                           for t in toks):
                fail(f"quant-parity: int8 KV request {i} returned {toks}")
        if counts.get("paged_decode_int8", 0) <= 0:
            fail("quant-parity: paged_decode_int8 never launched")
        band, agree, scale = kv_logit_band(model, prompts, plens, new)
        log(f"  {label}, int8 KV pages (fp32 weights): 6 requests x {new} "
            f"tokens complete; decode logits vs fp32 pages over {new} "
            f"steps: max |diff| {band:.5f} (logit scale {scale:.3f}), "
            f"argmax agrees at {100 * agree:.1f}% of positions")
        if not band <= KV_BAND_MAX * scale or agree < KV_AGREE_MIN:
            fail(f"quant-parity: int8 KV logits off fp32 pages by {band:.5f}"
                 f" (limit {KV_BAND_MAX * scale:.5f}) or argmax agreeing at "
                 f"{100 * agree:.1f}% (limit {100 * KV_AGREE_MIN:.0f}%)")
        del model
    torch.cuda.empty_cache()


def spec_batcher(model, width, pps, k=4, tree=None, draft=None, slots=2,
                 page_size=16):
    """A speculative ``ContinuousBatcher`` over a fresh cache: a chain
    verify with n-gram drafts, or the ``tree`` verify fed by ``draft``."""
    from apex_tpu_torch.serving import (
        ContinuousBatcher, KVCacheConfig, PagedKVCache, init_pools)

    c = model.config
    ccfg = KVCacheConfig(
        num_layers=c.num_layers, num_heads=c.num_attention_heads,
        head_dim=c.head_dim, num_pages=1 + slots * pps, page_size=page_size,
        max_seqs=slots, pages_per_seq=pps, dtype=c.compute_dtype)
    fns = model.decode_fns(ccfg, max_prompt_len=width, speculate_k=k,
                           spec_tree=tree, draft_model=draft)
    return ContinuousBatcher(
        fns.prefill, fns.decode, PagedKVCache(ccfg),
        init_pools(ccfg, model.device), max_prompt_len=width,
        harvest_every=4, spec_fn=fns.spec, speculate_k=k)


def draft_source(model, pps, tree, slots=2, page_size=16, k=4):
    """An int4 ``ModelDraftSource`` of ``model``'s own weights with its
    own small cache."""
    from apex_tpu_torch.serving import KVCacheConfig, ModelDraftSource

    c = model.config
    dcfg = KVCacheConfig(
        num_layers=c.num_layers, num_heads=c.num_attention_heads,
        head_dim=c.head_dim, num_pages=1 + slots * pps, page_size=page_size,
        max_seqs=slots, pages_per_seq=pps, dtype=c.compute_dtype)
    return ModelDraftSource(model, dcfg, k=k, tree=tree, weight_dtype="int4",
                            ingest_chunk=16)


def chunked_batcher(model, width, pps, chunk, slots=2, page_size=16,
                    prefix=True, kv_dtype=None, extra_pages=4):
    """A chunked (and by default prefix-cached) ``ContinuousBatcher``."""
    from apex_tpu_torch.serving import (
        ContinuousBatcher, KVCacheConfig, PagedKVCache, init_pools)

    c = model.config
    ccfg = KVCacheConfig(
        num_layers=c.num_layers, num_heads=c.num_attention_heads,
        head_dim=c.head_dim, num_pages=1 + (slots + extra_pages) * pps,
        page_size=page_size, max_seqs=slots, pages_per_seq=pps,
        dtype=c.compute_dtype, kv_dtype=kv_dtype)
    fns = model.decode_fns(ccfg, max_prompt_len=width, prefill_chunk=chunk)
    return ContinuousBatcher(
        fns.prefill, fns.decode, PagedKVCache(ccfg),
        init_pools(ccfg, model.device), max_prompt_len=width,
        harvest_every=4, chunk_fn=fns.chunk, prefill_chunk=chunk,
        prefix_cache=prefix)


def phase_chunked_parity(dev) -> dict:
    """Chunked prefill, the prefix cache and speculation at fp32, 2
    layers: the flagship (6 requests of 5..60 tokens, chunks of 16, pages
    of 16) and the Llama mode (4 requests of 50..600 tokens, chunks of
    128, pages of 64, rope in the many-row instance), 2 slots, 16 new
    tokens.  Rows 2 and 4 share row 0's first tokens: a whole-prompt
    page-aligned match (copy-on-write) and a partial one.  Gates: chunked
    + prefix-cached tokens == ``generate_reference``; a hit's logits
    bit-identical to a cold admission's; chain speculation (n-gram) and
    tree speculation (``offramp_tree(4)``, int4 ``ModelDraftSource``) ==
    ``generate_reference``; int8 KV chunked: every request completes, the
    logits within quant-parity's band.  Returns the launches."""
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import Request, offramp_tree

    log("[chunked-parity] 2 layers, fp32: chunked + prefix-cached and "
        "speculative paged greedy vs full recompute")
    new = 16
    torch.cuda.synchronize()
    reset_launch_counts()
    for label, sizes, seed, plens, share, chunk, page in (
            ("flagship", FLAGSHIP, 1, [48, 17, 32, 5, 60, 40], (32, 48), 16,
             16),
            ("Llama mode", LLAMA, 4, [600, 130, 256, 50], (256, None), 128,
             64)):
        cfg = GPTConfig(**dict(sizes, num_layers=2),
                        compute_dtype=torch.float32)
        model = GPTModel(cfg, device=dev, seed=seed)
        rng = np.random.RandomState(seed + 10)
        width = max(plens)
        pps = -(-(width + new + 8) // page)
        prompts = rng.randint(1, cfg.vocab_size,
                              (len(plens), width)).astype(np.int32)
        prompts[2, :share[0]] = prompts[0, :share[0]]
        if share[1]:
            prompts[4, :share[1]] = prompts[0, :share[1]]
        for i, n in enumerate(plens):
            prompts[i, n:] = 0
        ref = model.generate_reference(prompts, plens, new)
        want = {i: ref[i].tolist() for i in range(len(plens))}
        reqs = [Request(uid=i, prompt=prompts[i, :n].tolist(),
                        max_new_tokens=new) for i, n in enumerate(plens)]
        b = chunked_batcher(model, width, pps, chunk, page_size=page)
        comps = b.run(reqs)
        for i in want:
            if comps[i].tokens != want[i]:
                fail(f"chunked-parity: {label} request {i} chunked "
                     f"{comps[i].tokens} != reference {want[i]}")
        st = b.prefix_stats
        if st["hits"] < 1 or st["copied_pages"] < 1:
            fail(f"chunked-parity: {label} prefix stats {st}")
        log(f"  {label}: chunked (C={chunk}) + prefix cache: {len(plens)} "
            f"requests x {new} tokens identical; prefix {st}")
        # a hit's logits against a cold admission's, bit for bit, and a
        # page-aligned whole-prompt match (copy-on-write) against a fresh
        # batcher's cold admission
        prompt = prompts[0, :plens[0]].tolist()
        hot, fresh = (chunked_batcher(model, width, pps, chunk,
                                      page_size=page) for _ in range(2))

        def last_logits(bt, uid, pr):
            bt.run([Request(uid=uid, prompt=pr, max_new_tokens=2)])
            return bt.last_prefill_logits.clone()

        cold = last_logits(hot, "cold", prompt)
        hit = last_logits(hot, "hit", prompt)
        cow_cold = last_logits(fresh, "cc", prompt[:share[0]])
        cow_hit = last_logits(hot, "ch", prompt[:share[0]])
        if not (torch.equal(cold, hit) and torch.equal(cow_cold, cow_hit)):
            fail(f"chunked-parity: {label} prefix-hit logits differ from "
                 f"cold: max |diff| {max_err(cold, hit):.3g} / "
                 f"{max_err(cow_cold, cow_hit):.3g}")
        if hot.prefix_stats["hits"] < 2 or \
                hot.prefix_stats["copied_pages"] < 1 or \
                fresh.prefix_stats["hits"] != 0:
            fail(f"chunked-parity: {label} hit path not taken "
                 f"{hot.prefix_stats} / {fresh.prefix_stats}")
        log(f"  {label}: prefix-hit logits bit-identical to cold (a partial "
            "match and a copy-on-write whole-prompt match)")
        # speculation: chain with n-gram drafts, tree with the int4 draft
        for what, tree in (("chain, n-gram drafts", None),
                           ("offramp_tree(4), int4 draft model",
                            offramp_tree(4))):
            draft = None if tree is None else draft_source(
                model, pps, tree, page_size=page)
            sb = spec_batcher(model, width, pps, tree=tree, draft=draft,
                              page_size=page)
            comps = sb.run(reqs)
            for i in want:
                if comps[i].tokens != want[i]:
                    fail(f"chunked-parity: {label} {what} request {i} "
                         f"{comps[i].tokens} != reference {want[i]}")
            ss = sb.spec_stats
            log(f"  {label}: speculation ({what}): tokens identical; "
                f"{ss['committed']} tokens in {ss['steps']} verify steps, "
                f"{ss['accepted']} of {ss['drafted']} drafts accepted, "
                f"{ss['offramp']} off-ramp commits")
            if tree is not None and ss["accepted"] <= 0:
                fail(f"chunked-parity: {label} {what} accepted no draft")
        # int8 KV pages, chunked: completes, logits within the band
        b8 = chunked_batcher(model, width, pps, chunk, page_size=page,
                             kv_dtype=torch.int8)
        comps = b8.run(reqs)
        for i in want:
            toks = comps[i].tokens
            if len(toks) != new or not all(0 <= t < cfg.vocab_size
                                           for t in toks):
                fail(f"chunked-parity: {label} int8 KV request {i} "
                     f"returned {toks}")
        band, agree, scale = kv_logit_band(model, prompts, plens, new,
                                           page_size=page, chunk=chunk)
        log(f"  {label}, int8 KV chunked: {len(plens)} requests complete; "
            f"decode logits vs fp32 pages: max |diff| {band:.5f} (logit "
            f"scale {scale:.3f}), argmax agrees at {100 * agree:.1f}%")
        if not band <= KV_BAND_MAX * scale or agree < KV_AGREE_MIN:
            fail(f"chunked-parity: {label} int8 KV chunked logits off by "
                 f"{band:.5f} (limit {KV_BAND_MAX * scale:.5f}) or argmax "
                 f"at {100 * agree:.1f}% (limit {100 * KV_AGREE_MIN:.0f}%)")
        del model
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"  launches in this phase: {counts}")
    for name in ("paged_decode_rows", "paged_decode_tree", "paged_decode",
                 "paged_decode_int8", "dequant_int4"):
        if counts.get(name, 0) <= 0:
            fail(f"chunked-parity: kernel {name} never launched")
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- phase 4
#: sample-parity's sampling and its slot keys: seeded requests
SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.95)
#: a first GPU/CPU divergence may fall only where the CPU's top two
#: ``y + g`` lie within this share of the row's logit scale
SAMPLE_MARGIN_SHARE = 1e-4


class OracleDrafts:
    """Drafts a request's own plain stream (``streams``: prompt ->
    tokens), wrong at every third position it proposes: accepted prefixes
    of every length, and rejections whose correction must be the plain
    draw."""

    def __init__(self, streams, vocab: int, k: int = 4):
        self.streams, self.vocab, self.k = streams, vocab, k

    def draft(self, context, prompt_len):
        ref = self.streams[tuple(context[:prompt_len])]
        done = len(context) - prompt_len
        toks = list(ref[done:done + self.k])
        for j in range(len(toks)):
            if (done + j) % 3 == 2:
                toks[j] = (toks[j] + 1) % self.vocab
        return toks, "oracle"


def sampled_batcher(model, width, pps, slots=2, chunk=None, k=None,
                    tree=None, eager=False, key=None, sampling=SAMPLED,
                    page_size=16):
    """A ``ContinuousBatcher`` over a fresh cache serving ``sampling``:
    monolithic or chunked (prefix-cached) prefill, a chain or ``tree``
    verify of ``k`` drafts; ``eager`` drives ``decode_eager`` /
    ``spec_eager`` in place of the replayed steps."""
    from apex_tpu_torch.serving import (
        ContinuousBatcher, KVCacheConfig, PagedKVCache, init_pools)

    c = model.config
    ccfg = KVCacheConfig(
        num_layers=c.num_layers, num_heads=c.num_attention_heads,
        head_dim=c.head_dim, num_pages=1 + (slots + 4) * pps,
        page_size=page_size, max_seqs=slots, pages_per_seq=pps,
        dtype=c.compute_dtype)
    fns = model.decode_fns(ccfg, max_prompt_len=width, prefill_chunk=chunk,
                           speculate_k=k, spec_tree=tree, **sampling)
    spec = None if k is None else (fns.spec_eager if eager else fns.spec)
    return ContinuousBatcher(
        fns.prefill, fns.decode_eager if eager else fns.decode,
        PagedKVCache(ccfg), init_pools(ccfg, model.device),
        max_prompt_len=width, harvest_every=4, chunk_fn=fns.chunk,
        prefill_chunk=chunk, prefix_cache=chunk is not None, spec_fn=spec,
        speculate_k=k, key=key), fns


def first_divergence_margin(cpu_model, prompt, toks, seed, sampling):
    """The CPU's top-two margin of ``y + g`` (and the row's logit scale)
    at the draw of ``toks[-1]``, by full recompute."""
    from apex_tpu_torch.random import PRNGKey, keys_tensor
    from apex_tpu_torch.serving.sampling import _floor

    ctx = torch.tensor([prompt + toks[:-1]], dtype=torch.int32)
    with torch.no_grad():
        logits = cpu_model.apply(ctx)[0, -1].float()[None]
    t = sampling["temperature"]
    floor = _floor(logits, t, sampling.get("top_k"), sampling.get("top_p"))
    keys = keys_tensor(PRNGKey(seed), "cpu")
    n = torch.tensor([len(prompt) + len(toks) - 1], dtype=torch.int32)
    top2 = gumbel_plain_z(logits, keys, n, t, floor).topk(2).values[0]
    return (top2[0] - top2[1]).item(), logits.abs().max().item()


def phase_sample_parity(dev) -> dict:
    """Sampled serving at T=0.8, top-k 40, top-p 0.95 on seeded requests,
    the 2-layer fp32 flagship and Llama mode: the same tokens in two
    admission orders on 2 and 3 slots; chunked prefill with the prefix
    cache, chain speculation (n-gram drafts, and drafts of the stream
    itself, wrong at every third position) and tree speculation
    (offramp_tree(4)) commit the plain sampled stream; the GPU's stream
    equals the port's CPU stream on the same weights, a first divergence
    allowed only where the CPU's top-two margin is under 1e-4 of the logit
    scale; the replayed decode and verify steps give the eager steps'
    tokens, greedy and sampled, with equal launch counts; gumbel_argmax
    launches.  Returns the launches of the flagship's plain sampled
    run."""
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.random import PRNGKey
    from apex_tpu_torch.serving import Request, offramp_tree

    log(f"[sample-parity] 2 layers, fp32, {SAMPLED}, seeded requests")
    new, width, page, k = 16, 64, 16, 4
    pps = -(-(width + new + 2 * k) // page)
    out = {}
    for label, sizes, seed in (("flagship", FLAGSHIP, 5),
                               ("Llama mode", LLAMA, 6)):
        cfg = GPTConfig(**dict(sizes, num_layers=2),
                        compute_dtype=torch.float32)
        model = GPTModel(cfg, device=dev, seed=seed)
        rng = np.random.RandomState(seed)
        prompts = [rng.randint(1, cfg.vocab_size, n).tolist()
                   for n in (60, 17, 33, 8)]
        # two that share the first one's first 48 and 32 tokens
        prompts += [prompts[0][:48] + prompts[1][:9], prompts[0][:32]]

        def reqs(order=range(6)):
            return [Request(uid=i, prompt=prompts[i], max_new_tokens=new,
                            seed=100 + i) for i in order]

        def run(b, order=range(6)):
            comps = b.run(reqs(order))
            toks = {i: comps[i].tokens for i in range(6)}
            for i, t in toks.items():
                if len(t) != new or not all(0 <= x < cfg.vocab_size
                                            for x in t):
                    fail(f"sample-parity {label}: request {i} returned {t}")
            return toks

        def same(name, got, want):
            for i in range(6):
                if got[i] != want[i]:
                    fail(f"sample-parity {label} {name}: request {i} "
                         f"{got[i]} != plain sampled {want[i]}")

        torch.cuda.synchronize()
        reset_launch_counts()
        b, fns = sampled_batcher(model, width, pps, key=PRNGKey(0))
        ref = run(b)
        graphed = launch_counts()
        if graphed.get("gumbel_argmax", 0) <= 0:
            fail(f"sample-parity {label}: gumbel_argmax never launched")
        if fns.decode.graph.replays <= 0:
            fail(f"sample-parity {label}: the decode step never replayed")
        if label == "flagship":
            out = graphed
        # order and slots
        b3, _ = sampled_batcher(model, width, pps, slots=3, key=PRNGKey(9))
        same("3 slots, shuffled order", run(b3, [4, 2, 0, 5, 1, 3]), ref)
        same("2 slots, reversed order",
             run(sampled_batcher(model, width, pps, key=PRNGKey(3))[0],
                 [5, 4, 3, 2, 1, 0]), ref)
        # chunked prefill with the prefix cache
        bc, _ = sampled_batcher(model, width, pps, chunk=16)
        same("chunked (C=16), prefix-cached", run(bc), ref)
        if bc.prefix_stats["hits"] < 1:
            fail(f"sample-parity {label}: no prefix hit")
        notes = [f"prefix hits {bc.prefix_stats['hits']}"]
        # speculation
        oracle = OracleDrafts({tuple(prompts[i]): ref[i] for i in range(6)},
                              cfg.vocab_size, k)
        for name, tree, source in (
                ("chain, n-gram drafts", None, None),
                ("chain, drafts of the stream", None, oracle),
                ("offramp_tree(4), drafts of the stream", offramp_tree(k),
                 oracle)):
            bs, sfns = sampled_batcher(model, width, pps, k=k, tree=tree)
            if source is not None:
                bs.draft_source = source
            same(name, run(bs), ref)
            st = bs.spec_stats
            if source is not None and not 0 < st["accepted"] < st["drafted"]:
                fail(f"sample-parity {label} {name}: {st['accepted']} of "
                     f"{st['drafted']} drafts accepted")
            if sfns.spec.graph.replays <= 0:
                fail(f"sample-parity {label} {name}: no verify replay")
            notes.append(f"{name}: {st['accepted']}/{st['drafted']} "
                         f"accepted, {st['committed'] / st['slot_steps']:.2f}"
                         " committed a slot step")
        # replayed steps against eager ones: tokens and launches
        for sampling in (SAMPLED, {}):
            for k_ in (None, k):
                counts = []
                toks = []
                for eager in (False, True):
                    torch.cuda.synchronize()
                    reset_launch_counts()
                    bb, _ = sampled_batcher(model, width, pps, k=k_,
                                            eager=eager, key=PRNGKey(0),
                                            sampling=sampling)
                    toks.append(run(bb))
                    torch.cuda.synchronize()
                    counts.append(launch_counts())
                what = (f"{'sampled' if sampling else 'greedy'} "
                        f"{'verify' if k_ else 'decode'}")
                if toks[0] != toks[1]:
                    fail(f"sample-parity {label}: replayed {what} tokens "
                         "differ from the eager step's")
                if counts[0] != counts[1]:
                    fail(f"sample-parity {label}: replayed {what} launches "
                         f"{counts[0]} != eager {counts[1]}")
                if sampling and k_ is None and toks[0] != ref:
                    fail(f"sample-parity {label}: eager sampled run differs")
        notes.append("replayed == eager (greedy and sampled, decode and "
                     "verify), launches equal")
        # the GPU's stream against the port's CPU stream
        cpu = GPTModel(cfg, device="cpu")
        cpu.load_state_dict({n: t.cpu() for n, t in
                             model.state_dict().items()})
        bcpu, _ = sampled_batcher(cpu, width, pps, key=PRNGKey(0))
        cref = run(bcpu)
        diverged = []
        for i in range(6):
            if cref[i] == ref[i]:
                continue
            t = next(j for j in range(new) if cref[i][j] != ref[i][j])
            margin, scale = first_divergence_margin(
                cpu, prompts[i], cref[i][:t + 1], 100 + i, SAMPLED)
            diverged.append((i, t, margin, scale))
            log(f"  {label}: request {i} diverges from the CPU at token {t}"
                f": CPU top-two margin {margin:.3g} (logit scale "
                f"{scale:.3g})")
            if not margin < SAMPLE_MARGIN_SHARE * scale:
                fail(f"sample-parity {label}: request {i} GPU != CPU at "
                     f"token {t} with a margin of {margin:.3g}")
        log(f"  {label}: 6 seeded requests x {new} tokens: 2 and 3 slots, "
            f"two orders, chunked + prefix cache, chain and tree "
            f"speculation all equal the plain sampled stream; "
            f"{'; '.join(notes)}; GPU == CPU on "
            f"{6 - len(diverged)} of 6 streams")
        del model, cpu
    torch.cuda.empty_cache()
    return out


def phase_serve(dev) -> dict:
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import Request

    log("[serve] flagship GPT, 12 layers, bf16: 8 requests x 32 tokens, "
        "4 slots, pages 64 x 9")
    cfg = GPTConfig(**FLAGSHIP, compute_dtype=torch.bfloat16)
    model = GPTModel(cfg, device=dev, seed=0)
    plens = np.linspace(32, 512, 8).astype(int)
    rng = np.random.RandomState(0)
    new = 32
    reqs = [Request(uid=i, prompt=rng.randint(1, cfg.vocab_size, n).tolist(),
                    max_new_tokens=new) for i, n in enumerate(plens)]
    # one untimed request first: allocator warm-up and lazy module loads
    serve(model, [Request(uid="warm", prompt=[1, 2, 3], max_new_tokens=2)],
          512, 64, 4, 9)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    comps, wall, prefill_s, batcher = serve(model, reqs, 512, 64, 4, 9)
    torch.cuda.synchronize()
    # then one request past the short rung: a 900-token prompt, prefill
    # padded to 960 through mid_fwd
    long_req = Request(uid="long",
                       prompt=rng.randint(1, cfg.vocab_size, 900).tolist(),
                       max_new_tokens=new)
    long_comps, long_wall, long_prefill, _ = serve(model, [long_req], 960,
                                                   64, 1, 16)
    # the same requests through the eager decode step, and sampled
    others = {}
    for name, kw in (("eager", dict(eager=True)),
                     ("sampled, replayed", dict(sampling=SAMPLED)),
                     ("sampled, eager", dict(sampling=SAMPLED, eager=True))):
        o_comps, o_wall, o_prefill, o_b = serve(model, reqs, 512, 64, 4, 9,
                                                **kw)
        for i in range(len(reqs)):
            toks = o_comps[i].tokens
            if len(toks) != new or not all(0 <= t < cfg.vocab_size
                                           for t in toks):
                fail(f"serve {name}: request {i} returned {toks}")
        others[name] = (o_wall - sum(o_prefill)) / o_b.steps
    counts = launch_counts()
    toks = long_comps["long"].tokens
    if len(toks) != new or not all(0 <= t < cfg.vocab_size for t in toks):
        fail(f"serve: the 900-token request returned {toks}")
    log(f"  a 900-token prompt (prefill padded to 960, mid rung): {new} "
        f"tokens in {long_wall:.3f} s, prefill {1e3 * long_prefill[0]:.2f} "
        "ms")
    for i in range(len(reqs)):
        toks = comps[i].tokens
        if len(toks) != new or not all(0 <= t < cfg.vocab_size
                                       for t in toks):
            fail(f"serve: request {i} returned {toks}")
    decode_s = wall - sum(prefill_s)
    decode_tokens = len(reqs) * (new - 1)
    ttft = sorted(c.ttft_s for c in comps.values())
    log(f"  {len(reqs)} requests complete, {batcher.steps} decode steps "
        f"in {batcher.windows} harvest windows, wall {wall:.3f} s")
    log(f"  prefill: {int(plens.sum())} prompt tokens (padded to 512 per "
        f"request) in {sum(prefill_s):.3f} s = "
        f"{plens.sum() / sum(prefill_s):.1f} prompt tokens/s, "
        f"{1e3 * np.mean(prefill_s):.2f} ms per prefill")
    log(f"  decode: {decode_tokens} tokens in {decode_s:.3f} s = "
        f"{decode_tokens / decode_s:.1f} tokens/s, "
        f"{1e3 * decode_s / batcher.steps:.2f} ms per step (4 slots), "
        "replayed")
    for name, step_s in others.items():
        log(f"  decode {name} ({SAMPLED if 'sampled' in name else 'greedy'}"
            f"): {1e3 * step_s:.2f} ms per step, {1e3 * step_s / 4:.2f} ms "
            "per token (4 slots)")
    log(f"  TTFT p50 {1e3 * ttft[len(ttft) // 2]:.1f} ms, max "
        f"{1e3 * ttft[-1]:.1f} ms (quantized to the harvest window)")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    log(f"  launches in this phase: {counts}")
    for name in ("ln_fwd", "short_fwd", "mid_fwd", "paged_decode",
                 "gumbel_argmax"):
        if counts.get(name, 0) <= 0:
            fail(f"serve: kernel {name} never launched on the main path")
    # the bf16 path against the same weights at fp32 compute
    ref = GPTModel(dataclasses.replace(cfg, compute_dtype=torch.float32),
                   device=dev)
    ref.load_state_dict(model.state_dict())
    toks = torch.as_tensor([reqs[3].prompt], device=dev)
    with torch.no_grad():
        lo = model.apply(toks)[0].float()
        hi = ref.apply(toks)[0]
    band = (lo - hi).abs().max().item()
    agree = (lo.argmax(-1) == hi.argmax(-1)).float().mean().item()
    log(f"  bf16 vs fp32 logits over a {toks.shape[1]}-token prompt: max "
        f"|diff| {band:.4f} (logit scale {hi.abs().max().item():.3f}), "
        f"argmax agrees at {100 * agree:.1f}% of positions")
    del ref
    others["replayed"] = decode_s / batcher.steps
    return counts, model, others


def timed_steps(fns):
    """The prefill and chunk steps of ``fns`` wrapped to record each
    call's wall time (synchronised), for decode time = wall - prefill."""
    spent = []

    def wrap(fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            spent.append(time.perf_counter() - t0)
            return out
        return run

    return wrap(fns.prefill), (wrap(fns.chunk) if fns.chunk else None), spent


#: the JAX bench's mixed load (bench.py, "mixed_load" rows) at its
#: smallest batch: 7 short decoders and 4 long arrivals on 8 slots
MIX_PREFIX, MIX_TAIL, MIX_CHUNK, MIX_LONGS = 512, 8, 256, 4
MIX_SHORT_NEW, MIX_LONG_NEW, MIX_SLOTS = 24, 8, 8


def phase_serve_chunked(model) -> dict:
    """Phase 4's model (12-layer flagship, bf16) on the mixed load: 7
    short 8-token prompts (24 new tokens) and 4 long ones, a shared
    512-token prefix + 8-token tails (8 new), 8 slots, pages of 64,
    harvest every 4, ``measure_stall`` on.  One priming request (a long
    prompt) first, then the same traffic monolithic, chunked (C=256) and
    chunked with the prefix cache.  Every request must complete, and the
    chunked runs must launch the many-row instance.  Returns the
    launches of the chunked, prefix-cached run."""
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import (
        ContinuousBatcher, KVCacheConfig, PagedKVCache, Request, init_pools)

    c = model.config
    log(f"[serve-chunked] flagship GPT, 12 layers, bf16: {MIX_SLOTS - 1} "
        f"short prompts + {MIX_LONGS} long ({MIX_PREFIX}-token shared prefix"
        f" + {MIX_TAIL}-token tails), {MIX_SLOTS} slots; monolithic vs "
        f"chunked (C={MIX_CHUNK}) vs chunked + prefix cache")
    rng = np.random.RandomState(11)
    shared = rng.randint(1, c.vocab_size, MIX_PREFIX).tolist()
    longs = [shared + rng.randint(1, c.vocab_size, MIX_TAIL).tolist()
             for _ in range(MIX_LONGS)]
    shorts = [rng.randint(1, c.vocab_size, 8).tolist()
              for _ in range(MIX_SLOTS - 1)]
    long_len = MIX_PREFIX + MIX_TAIL
    pps = -(-(long_len + MIX_LONG_NEW) // 64)
    num_pages = 1 + (MIX_SLOTS - 1) + (MIX_LONGS + 2) * pps
    out = {}
    for name, chunked, prefix in (("monolithic", False, False),
                                  ("chunked", True, False),
                                  ("chunked + prefix cache", True, True)):
        ccfg = KVCacheConfig(
            num_layers=c.num_layers, num_heads=c.num_attention_heads,
            head_dim=c.head_dim, num_pages=num_pages, page_size=64,
            max_seqs=MIX_SLOTS, pages_per_seq=pps, dtype=c.compute_dtype)
        fns = model.decode_fns(ccfg, max_prompt_len=long_len,
                               prefill_chunk=MIX_CHUNK if chunked else None)
        prefill, chunk, spent = timed_steps(fns)
        b = ContinuousBatcher(
            prefill, fns.decode, PagedKVCache(ccfg),
            init_pools(ccfg, model.device), max_prompt_len=long_len,
            harvest_every=4, chunk_fn=chunk,
            prefill_chunk=MIX_CHUNK if chunked else None,
            prefix_cache=prefix, measure_stall=True)
        b.run([Request(uid="prime", prompt=longs[0], max_new_tokens=2)])
        b.decode_stall_s = b.max_prefill_stall_s = 0.0
        for k in b.prefix_stats:
            b.prefix_stats[k] = 0
        spent.clear()
        steps0, chunks0 = b.steps, b.prefill_chunks
        reqs = [Request(uid=f"s{i}", prompt=p, max_new_tokens=MIX_SHORT_NEW)
                for i, p in enumerate(shorts)]
        reqs += [Request(uid=f"L{j}", prompt=p, max_new_tokens=MIX_LONG_NEW)
                 for j, p in enumerate(longs)]
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        comps = b.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        for r in reqs:
            toks = comps[r.uid].tokens
            if len(toks) != r.max_new_tokens or not all(
                    0 <= t < c.vocab_size for t in toks):
                fail(f"serve-chunked {name}: request {r.uid} returned {toks}")
        steps = b.steps - steps0
        ttft = sorted(comps[f"L{j}"].ttft_s for j in range(MIX_LONGS))
        px = b.prefix_stats
        log(f"  {name}: wall {1e3 * wall:.1f} ms, {steps} decode steps, "
            f"decode {1e3 * (wall - sum(spent)) / steps:.2f} ms/step; "
            f"prefill {1e3 * sum(spent):.1f} ms in {len(spent)} calls "
            f"({b.prefill_chunks - chunks0} chunks); worst prefill stall "
            f"{1e3 * b.max_prefill_stall_s:.2f} ms, total stall "
            f"{1e3 * b.decode_stall_s:.1f} ms; long TTFT p50 "
            f"{1e3 * ttft[len(ttft) // 2]:.1f} ms, max {1e3 * ttft[-1]:.1f} "
            f"ms (harvest every 4)")
        if prefix:
            log(f"  prefix cache: {px['hits']} hits of {MIX_LONGS} long "
                f"arrivals, {px['shared_pages']} pages shared, "
                f"{px['tokens_skipped']} prompt tokens skipped, "
                f"{b.cache.allocator.num_shared} pages shared now")
            if px["hits"] < MIX_LONGS:
                fail(f"serve-chunked: {px['hits']} prefix hits of "
                     f"{MIX_LONGS} long arrivals")
        log(f"  launches: {counts}")
        if chunked and counts.get("paged_decode_rows", 0) <= 0:
            fail(f"serve-chunked {name}: paged_decode_rows never launched")
        out = counts
    return out


def phase_serve_spec(model) -> dict:
    """Phase 4's model (12-layer flagship, bf16): 4 slots of 32-token
    repetitive prompts (a 4-token pattern tiled), 16 new tokens (24 before
    the fp16 phases came, cut for the script's wall), k=4,
    pages of 64: plain decode, a chain verify with n-gram drafts, and an
    ``offramp_tree(4)`` verify fed by the int4 ``ModelDraftSource`` of the
    same weights; each greedy with the steps replayed, greedy eager, and
    sampled (:data:`SAMPLED`, replayed).  One priming request each first.
    Prints tokens committed per verify step, ms per committed token and
    the share of tokens equal to the plain run's (bf16: the verify and
    decode steps round differently, so identity is gated at fp32 in
    chunked-parity and sample-parity).  Returns the greedy replayed tree
    run's launches."""
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.random import PRNGKey
    from apex_tpu_torch.serving import (
        ContinuousBatcher, KVCacheConfig, PagedKVCache, Request, init_pools,
        NGramDraftSource, offramp_tree)

    k, new, plen, slots = 4, 16, 32, 4
    c = model.config
    log(f"[serve-spec] flagship GPT, 12 layers, bf16: {slots} slots of "
        f"{plen}-token repetitive prompts x {new} tokens, k={k}: plain vs "
        "n-gram chain vs offramp_tree(4) with the int4 draft model; greedy "
        f"replayed, greedy eager, sampled {SAMPLED} replayed")
    rng = np.random.RandomState(17)
    prompts = [np.tile(rng.randint(1, c.vocab_size, 4), plen // 4).tolist()
               for _ in range(slots)]
    pps = -(-(plen + new + 2 * k) // 64)
    plain_toks, out = {}, {}
    for name, spec, tree in (("plain", False, None),
                             ("n-gram chain", True, None),
                             ("int4 draft model, offramp_tree(4)", True,
                              offramp_tree(k))):
        ccfg = KVCacheConfig(
            num_layers=c.num_layers, num_heads=c.num_attention_heads,
            head_dim=c.head_dim, num_pages=1 + slots * pps, page_size=64,
            max_seqs=slots, pages_per_seq=pps, dtype=c.compute_dtype)
        draft = None if tree is None else draft_source(
            model, pps, tree, slots=slots, page_size=64, k=k)
        for mode in ("greedy, replayed", "greedy, eager",
                     "sampled, replayed"):
            sampling = SAMPLED if mode.startswith("sampled") else {}
            eager = mode.endswith("eager")
            fns = model.decode_fns(ccfg, max_prompt_len=plen,
                                   speculate_k=k if spec else None,
                                   spec_tree=tree, draft_model=draft,
                                   **sampling)
            kw = {}
            if spec:
                kw = dict(spec_fn=fns.spec_eager if eager else fns.spec,
                          speculate_k=k)
                if tree is None:
                    kw["draft_source"] = NGramDraftSource(k)
            b = ContinuousBatcher(
                fns.prefill, fns.decode_eager if eager else fns.decode,
                PagedKVCache(ccfg), init_pools(ccfg, model.device),
                max_prompt_len=plen, harvest_every=4, key=PRNGKey(0), **kw)
            b.run([Request(uid="prime", prompt=prompts[0],
                           max_new_tokens=4)])
            for key in b.spec_stats:
                b.spec_stats[key] = {} if key == "by_source" else 0
            reqs = [Request(uid=i, prompt=p, max_new_tokens=new,
                            seed=200 + i) for i, p in enumerate(prompts)]
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            comps = b.run(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            toks = [comps[i].tokens for i in range(slots)]
            for i, t in enumerate(toks):
                if len(t) != new or not all(0 <= x < c.vocab_size
                                            for x in t):
                    fail(f"serve-spec {name} {mode}: request {i} returned "
                         f"{t}")
            base = plain_toks.setdefault(bool(sampling), toks)
            same = np.mean([a == b_ for x, y in zip(toks, base)
                            for a, b_ in zip(x, y)])
            st = b.spec_stats
            per_step = (st["committed"] / st["slot_steps"] if spec else 1.0)
            log(f"  {name}, {mode}: {1e3 * wall:.1f} ms for {slots * new} "
                f"tokens = {1e3 * wall / (slots * new):.2f} ms per committed"
                f" token; {per_step:.3f} tokens committed per slot per "
                "verify step"
                + (f" ({st['steps']} verify steps, {st['accepted']} of "
                   f"{st['drafted']} drafts accepted, {st['offramp']} "
                   f"off-ramp commits, draft {1e3 * st['draft_s']:.1f} ms)"
                   if spec else "")
                + f"; {100 * same:.1f}% of tokens equal to plain "
                f"{'sampled' if sampling else 'greedy'}")
            log(f"  launches: {counts}")
            if sampling and counts.get("gumbel_argmax", 0) <= 0:
                fail(f"serve-spec {name} {mode}: gumbel_argmax never "
                     "launched")
            if tree is not None and mode == "greedy, replayed":
                for need in ("paged_decode_tree", "dequant_int4",
                             "paged_decode_rows"):
                    if counts.get(need, 0) <= 0:
                        fail(f"serve-spec {name}: {need} never launched")
                out = counts
    return out


def phase_fused_softmax(dev) -> dict:
    """``FusedScaleMaskSoftmax`` (the port's entry point for the softmax
    kernel) at the flagship's attention-score shape (8, 8, 1024, 1024),
    bf16, scale d^-0.5: padding (a (b, 1, sq, sk) mask of keys past each
    sequence's length) and causal, forward and backward through autograd,
    against the plain version (two bf16 ulps).  Returns the launches."""
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.ops import softmax as sm
    from apex_tpu_torch.transformer import AttnMaskType
    from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax

    b, np_, s, _ = SOFTMAX_SHAPE
    scale = 128 ** -0.5
    log(f"[fused-softmax] FusedScaleMaskSoftmax, ({b}, {np_}, {s}, {s}) "
        "bf16, padding mask and causal, forward and backward")
    gen = torch.Generator(device=dev).manual_seed(3)
    x = (3 * torch.randn(b, np_, s, s, generator=gen, device=dev)).to(
        torch.bfloat16)
    dy = torch.randn(b, np_, s, s, generator=gen, device=dev).to(
        torch.bfloat16)
    lens = torch.randint(s // 2, s + 1, (b,), generator=gen, device=dev)
    mask = (torch.arange(s, device=dev)[None, :] >= lens[:, None])[
        :, None, None, :].expand(b, 1, s, s)
    torch.cuda.synchronize()
    reset_launch_counts()
    for mask_type, m in ((AttnMaskType.padding, mask),
                         (AttnMaskType.causal, None)):
        f = FusedScaleMaskSoftmax(input_in_bf16=True,
                                  attn_mask_type=mask_type, scale=scale)
        if not f.is_kernel_available(m, b, np_, s, s, device=dev):
            fail("fused-softmax: kernel not available on the card")
        xg = x.detach().requires_grad_()
        y = f(xg, m)
        y.backward(dy)
        want = sm._softmax_fwd_plain(x, m, scale,
                                     mask_type == AttnMaskType.causal)
        yf, dyf = want.float(), dy.float()
        dx = (scale * yf * (dyf - (dyf * yf).sum(-1, keepdim=True))).to(
            torch.bfloat16)
        check("softmax_fwd", y, want, f"FusedScaleMaskSoftmax {mask_type.name}"
              " y")
        check("softmax_fwd", xg.grad, dx,
              f"FusedScaleMaskSoftmax {mask_type.name} dx")
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"  launches: {counts}")
    if counts.get("softmax_fwd", 0) != 2:
        fail(f"fused-softmax: softmax_fwd launched {counts} times, not 2")
    return counts


def phase_serve_chunked_long(model) -> dict:
    """Serve-long's model (12-layer Llama mode, bf16): one 2300-token
    prompt in 256-token chunks (9 chunks, rope in the many-row instance,
    up to 2304 cached tokens), 32 new tokens.  Returns the launches."""
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import Request

    c = model.config
    log("[serve-chunked-long] Llama-mode GPT, 12 layers, bf16: a "
        "2300-token prompt in 256-token chunks, 32 new tokens")
    prompt = np.random.RandomState(8).randint(1, c.vocab_size,
                                              2300).tolist()
    b = chunked_batcher(model, 2304, 37, 256, slots=1, page_size=64,
                        prefix=False, extra_pages=0)
    b.run([Request(uid="warm", prompt=prompt[:300], max_new_tokens=2)])
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    comps = b.run([Request(uid="long", prompt=prompt, max_new_tokens=32)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    toks = comps["long"].tokens
    if len(toks) != 32 or not all(0 <= t < c.vocab_size for t in toks):
        fail(f"serve-chunked-long: the request returned {toks}")
    log(f"  9 chunks + 31 decode steps in {1e3 * wall:.1f} ms, TTFT "
        f"{1e3 * comps['long'].ttft_s:.1f} ms; launches {counts}")
    if counts.get("paged_decode_rows", 0) <= 0:
        fail("serve-chunked-long: paged_decode_rows never launched")
    return counts


def phase_serve_long(dev):
    """The 12-layer Llama-mode GPT in bf16 serves four requests of 2300,
    1500, 700 and 64 prompt tokens, 32 greedy tokens each, 4 slots, pages
    of 64: every prefill is padded to 2304 tokens (the flash rung) and
    every decode step rotates q in the paged kernel.  Returns the
    model."""
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import Request

    log("[serve-long] Llama-mode GPT, 12 layers, bf16: 4 requests of "
        "64..2300 prompt tokens x 32 tokens, 4 slots, pages 64 x 37")
    cfg = GPTConfig(**LLAMA, compute_dtype=torch.bfloat16)
    model = GPTModel(cfg, device=dev, seed=0)
    rng = np.random.RandomState(6)
    plens, new, width, pps = [2300, 1500, 700, 64], 32, 2304, 37
    reqs = [Request(uid=i, prompt=rng.randint(1, cfg.vocab_size, n).tolist(),
                    max_new_tokens=new) for i, n in enumerate(plens)]
    serve(model, [Request(uid="warm", prompt=[1, 2, 3], max_new_tokens=2)],
          width, 64, 4, pps)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    comps, wall, prefill_s, batcher = serve(model, reqs, width, 64, 4, pps)
    torch.cuda.synchronize()
    counts = launch_counts()
    for i in range(len(reqs)):
        toks = comps[i].tokens
        if len(toks) != new or not all(0 <= t < cfg.vocab_size
                                       for t in toks):
            fail(f"serve-long: request {i} returned {toks}")
    decode_s = wall - sum(prefill_s)
    log(f"  {len(reqs)} requests complete, {batcher.steps} decode steps, "
        f"wall {wall:.3f} s; prefill of {width} tokens "
        f"{1e3 * np.mean(prefill_s):.2f} ms each; decode "
        f"{1e3 * decode_s / batcher.steps:.2f} ms per step (4 slots)")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; launches in this phase: {counts}")
    for name in ("ln_fwd", "flash_fwd", "paged_decode"):
        if counts.get(name, 0) <= 0:
            fail(f"serve-long: kernel {name} never launched on the main path")
    phase_profile(model, prompt=2300, width=width, pps=pps,
                  what="Llama-mode GPT")
    return model


def phase_serve_quant(model) -> dict:
    """Phase 4's model and requests (12-layer flagship, bf16 compute, 8
    requests of 32..512 tokens x 32 new tokens, 4 slots, pages 64 x 9)
    served from weights {bf16 copies made once, int8, int4} x KV pages
    {bf16, int8}.  Every request must complete, and the dequant kernels
    and the int8-page decode kernel must launch.  Then one decode window
    profiled with the bf16 copies (phase 5's ran without them) and one at
    int4 weights with int8 KV.  Each run is timed with the decode step
    replayed and eager, and a seventh samples at int4 weights and int8 KV.
    Returns the launches of the fourteen runs."""
    from apex_tpu_torch.models.gpt import quantize_gpt_weights
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import Request

    log("[serve-quant] flagship GPT, 12 layers, bf16: weights {bf16, int8, "
        "int4} x KV {bf16, int8}, 8 requests x 32 tokens, 4 slots, pages "
        "64 x 9")
    c, dev = model.config, model.device
    plens = np.linspace(32, 512, 8).astype(int)
    rng = np.random.RandomState(0)
    new = 32
    reqs = [Request(uid=i, prompt=rng.randint(1, c.vocab_size, n).tolist(),
                    max_new_tokens=new) for i, n in enumerate(plens)]
    served = {"bf16": model}
    for wd in ("int8", "int4"):
        served[wd] = quantize_gpt_weights(model, wd)
    # the quantized logits against bf16 weights on one fixed prompt
    toks = torch.as_tensor([reqs[3].prompt], device=dev)
    with torch.no_grad():
        ref = model.apply(toks)[0].float()
        for wd in ("int8", "int4"):
            lo = served[wd].apply(toks)[0].float()
            agree = (lo.argmax(-1) == ref.argmax(-1)).float().mean().item()
            log(f"  {wd} vs bf16 weights, logits over a {toks.shape[1]}-token "
                f"prompt: max |diff| {(lo - ref).abs().max().item():.4f} "
                f"(logit scale {ref.abs().max().item():.3f}), argmax agrees "
                f"at {100 * agree:.1f}% of positions")
    serve(served["int4"], [Request(uid="warm", prompt=[1, 2, 3],
                                   max_new_tokens=2)], 512, 64, 4, 9,
          weight_dtype="int4", kv_dtype=torch.int8)
    torch.cuda.synchronize()
    reset_launch_counts()
    runs = [(wd, kv_dtype, None) for wd in ("bf16", "int8", "int4")
            for kv_dtype in (None, torch.int8)]
    runs.append(("int4", torch.int8, SAMPLED))
    for wd, kv_dtype, sampling in runs:
        step_s = {}
        for eager in (False, True):
            comps, wall, prefill_s, b = serve(
                served[wd], reqs, 512, 64, 4, 9, weight_dtype=wd,
                kv_dtype=kv_dtype, eager=eager, sampling=sampling)
            for i in range(len(reqs)):
                got = comps[i].tokens
                if len(got) != new or not all(0 <= t < c.vocab_size
                                              for t in got):
                    fail(f"serve-quant: {wd} weights request {i} returned "
                         f"{got}")
            step_s[eager] = (wall - sum(prefill_s)) / b.steps
        wbytes = b.decode_fn.weight_stream_bytes
        kv_bytes = sum(p.numel() * p.element_size()
                       for p in b.pools.values())
        log(f"  weights {wd} ({b.decode_fn.weight_dtype}), KV "
            f"{'int8' if kv_dtype else 'bf16'}"
            f"{', sampled ' + str(sampling) if sampling else ''}: decode "
            f"{1e3 * step_s[False]:.2f} ms/step replayed "
            f"({1e3 * step_s[False] / 4:.2f} ms a token; eager "
            f"{1e3 * step_s[True]:.2f}), prefill "
            f"{1e3 * np.mean(prefill_s):.2f} ms each; a replayed decode "
            f"step streams {wbytes / 1e6:.1f} MB of weights = "
            f"{wbytes / step_s[False] / 1e9:.1f} GB/s; KV pool "
            f"{kv_bytes / 1e6:.1f} MB")
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"  launches in the fourteen runs: {counts}")
    for name in ("dequant_int8", "dequant_int4", "paged_decode_int8",
                 "paged_decode", "short_fwd", "ln_fwd"):
        if counts.get(name, 0) <= 0:
            fail(f"serve-quant: kernel {name} never launched")
    phase_profile(model, what="flagship GPT, bf16 weight copies made once",
                  weight_dtype="bf16")
    phase_profile(served["int4"], what="flagship GPT, int4 weights, int8 KV",
                  kv_dtype=torch.int8)
    return counts


def phase_serve_quant_long(model) -> None:
    """Serve-long's model and four requests (64..2300 prompt tokens,
    prefill padded to 2304 on the flash rung) from int8 weights and int8
    KV pages: the dequant kernels take m=2304 in prefill."""
    from apex_tpu_torch.models.gpt import quantize_gpt_weights
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import Request

    log("[serve-quant-long] Llama-mode GPT, 12 layers, bf16, int8 weights "
        "and int8 KV: 4 requests of 64..2300 prompt tokens x 32 tokens")
    c = model.config
    rng = np.random.RandomState(6)
    plens, new, width, pps = [2300, 1500, 700, 64], 32, 2304, 37
    reqs = [Request(uid=i, prompt=rng.randint(1, c.vocab_size, n).tolist(),
                    max_new_tokens=new) for i, n in enumerate(plens)]
    qm = quantize_gpt_weights(model, "int8")
    torch.cuda.synchronize()
    reset_launch_counts()
    comps, wall, prefill_s, b = serve(qm, reqs, width, 64, 4, pps,
                                      weight_dtype="int8",
                                      kv_dtype=torch.int8)
    torch.cuda.synchronize()
    counts = launch_counts()
    for i in range(len(reqs)):
        got = comps[i].tokens
        if len(got) != new or not all(0 <= t < c.vocab_size for t in got):
            fail(f"serve-quant-long: request {i} returned {got}")
    for name in ("dequant_int8", "paged_decode_int8", "flash_fwd"):
        if counts.get(name, 0) <= 0:
            fail(f"serve-quant-long: kernel {name} never launched")
    log(f"  {len(reqs)} requests complete, {b.steps} decode steps; prefill "
        f"of {width} tokens {1e3 * np.mean(prefill_s):.2f} ms each; decode "
        f"{1e3 * (wall - sum(prefill_s)) / b.steps:.2f} ms per step; "
        f"launches {counts}")


# ------------------------------------------------------ fp16 serving (O2)
#: a first divergence of an fp16 greedy stream from its reference may fall
#: only where the reference's top two logits lie within this share of the
#: logit scale: fp16 rounds at other points on the two paths (the decode
#: kernel keeps q rotated in fp32 and its softmax in fp32, the prefill's
#: tensor cores round the probabilities to fp16), about 2**-11 of a value
#: a rounding over 2 layers; 1% is the fp16 band of the CPU tests
#: (``tests/test_torch_serving_fp16.py``)
FP16_MARGIN_SHARE = 0.01
#: the GPU-vs-CPU fp16 model: CPU fp16 products are slow, so a narrow GPT
#: whose heads keep the kernels' d=128 (2 layers, hidden 256, vocab 512)
FP16_CPU_SIZES = dict(vocab_size=512, num_layers=2, hidden_size=256,
                      num_attention_heads=2, ffn_hidden_size=1024,
                      max_position_embeddings=256)
#: the fp16 instances on the fp16 serving path
SERVE_F16 = ("paged_decode_f16", "paged_decode_int8_f16",
             "paged_decode_rows_f16", "paged_decode_tree_f16",
             "dequant_int8_f16", "dequant_int4_f16")


def o2_model(sizes, dev, seed):
    """A GPT at O2 (fp16 parameters and compute, fp32 norms), random
    weights from ``seed``."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import GPTConfig, GPTModel

    return GPTModel(GPTConfig(**sizes, policy=amp.get_policy("O2")),
                    device=dev, seed=seed)


def greedy_margin(model, context) -> tuple:
    """``model``'s top-two logit margin and logit scale after ``context``
    (full recompute)."""
    ctx = torch.tensor([context], dtype=torch.int32, device=model.device)
    with torch.no_grad():
        row = model.apply(ctx)[0, -1].float()
    top = row.topk(2).values
    return (top[0] - top[1]).item(), row.abs().max().item()


def same_greedy(label, ref_model, prompts, got, want) -> int:
    """``got`` equal to ``want`` stream by stream, or equal up to a first
    divergence where ``ref_model``'s top two logits lie within
    :data:`FP16_MARGIN_SHARE` of the logit scale.  Returns the number of
    streams that diverged."""
    diverged = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        t = next(j for j in range(len(w)) if j >= len(g) or g[j] != w[j])
        margin, scale = greedy_margin(ref_model, list(prompts[i]) + w[:t])
        log(f"  {label}: stream {i} diverges at token {t}: top-two margin "
            f"{margin:.4g} (logit scale {scale:.4g})")
        if not margin < FP16_MARGIN_SHARE * scale:
            fail(f"{label}: stream {i} {g} != {w} at token {t} with a "
                 f"top-two margin of {margin:.4g} (scale {scale:.4g})")
        diverged += 1
    return diverged


def phase_serve_fp16_parity(dev) -> None:
    """fp16 serving gates, 2 layers at the flagship's width at O2: paged
    greedy == ``generate_reference`` at fp16 on the same model and weight
    pool (fp16, int8, int4), monolithic, chunked + prefix-cached and
    chain/tree speculative (a first divergence only under
    :data:`FP16_MARGIN_SHARE`); a prefix hit's logits bit-identical to a
    cold prefill's; int8 KV pages within quant-parity's band of fp16
    pages; the replayed decode and verify steps equal the eager steps bit
    for bit (tokens, the K/V pools) with equal launches; then the GPU's
    greedy and sampled streams against the CPU's on the same weights
    (:data:`FP16_CPU_SIZES`)."""
    from apex_tpu_torch.models.gpt import quantize_gpt_weights
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.random import PRNGKey
    from apex_tpu_torch.serving import Request, offramp_tree

    log("[serve-fp16-parity] 2 layers at the flagship's width, O2 (fp16): "
        "paged vs recompute, prefix hit vs cold, replayed vs eager, GPU vs "
        "CPU")
    new, page, chunk = 16, 16, 16
    plens = [48, 17, 32, 5, 60, 40]
    model = o2_model(dict(FLAGSHIP, num_layers=2), dev, seed=1)
    vocab = model.config.vocab_size
    rng = np.random.RandomState(11)
    width = max(plens)
    pps = -(-(width + new + 8) // page)
    prompts = rng.randint(1, vocab, (len(plens), width)).astype(np.int32)
    prompts[2, :32] = prompts[0, :32]
    prompts[4, :48] = prompts[0, :48]
    for i, n in enumerate(plens):
        prompts[i, n:] = 0
    rows = [prompts[i, :n].tolist() for i, n in enumerate(plens)]
    reqs = [Request(uid=i, prompt=rows[i], max_new_tokens=new)
            for i in range(len(plens))]
    notes = []
    for wd in (None, "int8", "int4"):
        m = model if wd is None else quantize_gpt_weights(model, wd)
        want = m.generate_reference(prompts, plens, new).tolist()
        comps, _, _, _ = serve(m, reqs, max_prompt_len=width, page_size=page,
                               max_seqs=2, pages_per_seq=pps, harvest_every=4)
        got = [comps[i].tokens for i in range(len(plens))]
        d = same_greedy(f"serve-fp16-parity {wd or 'fp16'} weights", m,
                        rows, got, want)
        notes.append(f"{wd or 'fp16'} weights {len(plens) - d}/{len(plens)}")
        if wd is not None:
            continue
        b = chunked_batcher(model, width, pps, chunk, page_size=page)
        comps = b.run(reqs)
        d = same_greedy("serve-fp16-parity chunked + prefix cache", model,
                        rows, [comps[i].tokens for i in range(len(plens))],
                        want)
        notes.append(f"chunked + prefix {len(plens) - d}/{len(plens)} "
                     f"(prefix {b.prefix_stats['hits']} hits)")
        for what, tree in (("chain", None), ("offramp_tree(4)",
                                             offramp_tree(4))):
            draft = None if tree is None else draft_source(
                model, pps, tree, page_size=page)
            sb = spec_batcher(model, width, pps, tree=tree, draft=draft,
                              page_size=page)
            comps = sb.run(reqs)
            d = same_greedy(f"serve-fp16-parity {what}", model, rows,
                            [comps[i].tokens for i in range(len(plens))],
                            want)
            notes.append(f"{what} {len(plens) - d}/{len(plens)} "
                         f"({sb.spec_stats['accepted']} of "
                         f"{sb.spec_stats['drafted']} drafts accepted)")
    log("  streams equal to recompute: " + "; ".join(notes))
    # a prefix hit's logits against a cold prefill's, bit for bit
    hot, fresh = (chunked_batcher(model, width, pps, chunk, page_size=page)
                  for _ in range(2))

    def last_logits(bt, uid, pr):
        bt.run([Request(uid=uid, prompt=pr, max_new_tokens=2)])
        return bt.last_prefill_logits.clone()

    cold = last_logits(hot, "cold", rows[0])
    hit = last_logits(hot, "hit", rows[0])
    cow_cold = last_logits(fresh, "cc", rows[0][:32])
    cow_hit = last_logits(hot, "ch", rows[0][:32])
    if cold.dtype != torch.float16 or not (
            torch.equal(cold, hit) and torch.equal(cow_cold, cow_hit)):
        fail(f"serve-fp16-parity: prefix-hit logits ({cold.dtype}) differ "
             f"from cold: {max_err(cold, hit):.3g} / "
             f"{max_err(cow_cold, cow_hit):.3g}")
    log("  prefix-hit fp16 logits bit-identical to cold (a partial match "
        "and a copy-on-write whole-prompt match)")
    # int8 KV pages against fp16 pages
    band, agree, scale = kv_logit_band(model, prompts, np.array(plens), new)
    log(f"  int8 KV pages vs fp16 pages over {new} decode steps: max |diff| "
        f"{band:.5f} (logit scale {scale:.3f}), argmax agrees at "
        f"{100 * agree:.1f}%")
    if not band <= KV_BAND_MAX * scale or agree < KV_AGREE_MIN:
        fail(f"serve-fp16-parity: int8 KV logits off fp16 pages by "
             f"{band:.5f} (limit {KV_BAND_MAX * scale:.5f}) or argmax at "
             f"{100 * agree:.1f}%")
    # the replayed steps against the eager ones: tokens, pools, launches
    for sampling in ({}, SAMPLED):
        for k_ in (None, 4):
            runs = []
            for eager in (False, True):
                torch.cuda.synchronize()
                reset_launch_counts()
                bb, _ = sampled_batcher(model, width, pps, k=k_, eager=eager,
                                        key=PRNGKey(0), sampling=sampling,
                                        page_size=page)
                comps = bb.run([Request(uid=i, prompt=rows[i],
                                        max_new_tokens=new, seed=100 + i)
                                for i in range(len(plens))])
                torch.cuda.synchronize()
                runs.append(([comps[i].tokens for i in range(len(plens))],
                             {n: t.clone() for n, t in bb.pools.items()},
                             launch_counts()))
            what = (f"{'sampled' if sampling else 'greedy'} "
                    f"{'verify' if k_ else 'decode'}")
            (tr, pr, cr), (te, pe, ce) = runs
            # the K/V every request wrote: page 0, the null page, takes
            # the idle slots' garbage, which the graph's static inputs
            # make other garbage
            off = [n for n in pr if not torch.equal(pr[n][:, 1:],
                                                    pe[n][:, 1:])]
            if tr != te or off:
                fail(f"serve-fp16-parity: replayed {what} differs from the "
                     f"eager step: tokens equal {tr == te}, pools off {off} "
                     f"(max |diff| " + ", ".join(
                         f"{max_err(pr[n][:, 1:], pe[n][:, 1:]):.3g}"
                         for n in off) + ")")
            if cr != ce:
                fail(f"serve-fp16-parity: replayed {what} launches {cr} != "
                     f"eager {ce}")
            if not any(n.endswith("_f16") for n in cr):
                fail(f"serve-fp16-parity: {what} launched no fp16 instance")
    log("  replayed == eager, bit for bit (tokens and the fp16 K/V pools "
        "past the null page), greedy and sampled, decode and verify; "
        "launches equal")
    del model
    torch.cuda.empty_cache()
    # the GPU's streams against the CPU's on the same weights
    gpu = o2_model(FP16_CPU_SIZES, dev, seed=3)
    cpu = o2_model(FP16_CPU_SIZES, "cpu", seed=3)
    cpu.load_state_dict({n: t.cpu() for n, t in gpu.state_dict().items()})
    crng = np.random.RandomState(12)
    cplens = [40, 23, 64, 9]
    cprompts = [crng.randint(1, gpu.config.vocab_size, n).tolist()
                for n in cplens]
    creqs = [Request(uid=i, prompt=cprompts[i], max_new_tokens=new,
                     seed=200 + i) for i in range(len(cplens))]
    streams = {}
    for label, m in (("gpu", gpu), ("cpu", cpu)):
        for sampling in ({}, SAMPLED):
            b, _ = sampled_batcher(m, 64, -(-(64 + new + 8) // page),
                                   key=PRNGKey(0), sampling=sampling,
                                   page_size=page)
            comps = b.run(creqs)
            streams[(label, bool(sampling))] = [comps[i].tokens
                                                for i in range(len(cplens))]
    d = same_greedy("serve-fp16-parity GPU vs CPU, greedy", cpu, cprompts,
                    streams[("gpu", False)], streams[("cpu", False)])
    sd = 0
    for i, (g, c) in enumerate(zip(streams[("gpu", True)],
                                   streams[("cpu", True)])):
        if g == c:
            continue
        t = next(j for j in range(new) if g[j] != c[j])
        margin, scale = first_divergence_margin(cpu, cprompts[i],
                                                c[:t + 1], 200 + i, SAMPLED)
        log(f"  sampled stream {i} diverges from the CPU at token {t}: "
            f"CPU top-two margin {margin:.4g} (logit scale {scale:.4g})")
        if not margin < FP16_MARGIN_SHARE * scale:
            fail(f"serve-fp16-parity: sampled stream {i} GPU != CPU at "
                 f"token {t} with a margin of {margin:.4g}")
        sd += 1
    log(f"  GPU == CPU (hidden {gpu.config.hidden_size}, "
        f"{gpu.config.num_layers} layers, O2): greedy "
        f"{len(cplens) - d}/{len(cplens)}, sampled {len(cplens) - sd}/"
        f"{len(cplens)} streams equal, the rest diverging only under the "
        "margin")
    del gpu, cpu
    torch.cuda.empty_cache()


def phase_serve_fp16(dev, bf16_step_s) -> dict:
    """The full flagship at O2 (fp16 weights and pages, fp32 norms), one
    model built once: phase 4's 8 requests greedy through
    ``ContinuousBatcher``, replayed and eager (decode ms/step beside
    phase 4's bf16 in this run), TTFT; one run each from int8 weights and
    from int8 KV pages; one chunked (C=256), prefix-cached run (a shared
    256-token prefix); one ``offramp_tree(4)`` speculative run from the
    int4 draft model; one sampled run; the fp16 logits against the same
    weights at fp32 compute.  Then the Llama mode at O2 serves one
    2300-token prompt (the flash rung's fp16 forward, the decode kernel's
    fused q-RoPE).  Every fp16 serving instance (:data:`SERVE_F16`) must
    launch.  Returns the launches of the whole phase."""
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import Request, offramp_tree

    log("[serve-fp16] flagship GPT, 12 layers, O2 (fp16): 8 requests x 32 "
        "tokens, 4 slots, pages 64 x 9")
    model = o2_model(FLAGSHIP, dev, seed=0)
    vocab = model.config.vocab_size
    plens = np.linspace(32, 512, 8).astype(int)
    rng = np.random.RandomState(0)
    new = 32
    reqs = [Request(uid=i, prompt=rng.randint(1, vocab, n).tolist(),
                    max_new_tokens=new) for i, n in enumerate(plens)]
    serve(model, [Request(uid="warm", prompt=[1, 2, 3], max_new_tokens=2)],
          512, 64, 4, 9)
    total = {}

    def run(label, fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = launch_counts()
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
        return out, counts

    def complete(label, comps, n):
        for uid, c in comps.items():
            if len(c.tokens) != n or not all(0 <= t < vocab
                                             for t in c.tokens):
                fail(f"serve-fp16 {label}: request {uid} returned "
                     f"{c.tokens}")

    step_s = {}
    for label, kw in (("replayed", {}), ("eager", dict(eager=True)),
                      ("int8 weights", dict(weight_dtype="int8")),
                      ("int8 KV", dict(kv_dtype=torch.int8)),
                      ("sampled, replayed", dict(sampling=SAMPLED))):
        (comps, wall, prefill_s, b), _ = run(label, lambda kw=kw: serve(
            model, reqs, 512, 64, 4, 9, **kw))
        complete(label, comps, new)
        step_s[label] = (wall - sum(prefill_s)) / b.steps
        if label == "replayed":
            ttft = sorted(c.ttft_s for c in comps.values())
            log(f"  prefill {1e3 * np.mean(prefill_s):.2f} ms per prefill; "
                f"TTFT p50 {1e3 * ttft[len(ttft) // 2]:.1f} ms, max "
                f"{1e3 * ttft[-1]:.1f} ms (quantized to the harvest window)")
    for label, s in step_s.items():
        bf = bf16_step_s.get(label)
        log(f"  decode {label}: {1e3 * s:.2f} ms/step (4 slots)"
            + ("" if bf is None else
               f"; bf16 {1e3 * bf:.2f} ms/step in phase 4 of this run, "
               f"{s / bf:.3f}x"))
    # chunked and prefix-cached: 4 requests sharing a 256-token prefix,
    # after one that leaves it in the prefix index
    prefix = rng.randint(1, vocab, 256).tolist()
    creqs = [Request(uid=f"c{i}", prompt=prefix + rng.randint(
        1, vocab, 8 + 40 * i).tolist(), max_new_tokens=16) for i in range(4)]
    b = chunked_batcher(model, 512, 9, 256, slots=4, page_size=64)
    # one priming request leaves the prefix's pages in the index
    b.run([Request(uid="prime", prompt=prefix + [1, 2], max_new_tokens=2)])
    comps, counts = run("chunked", lambda: b.run(creqs))
    complete("chunked", {u: c for u, c in comps.items() if u != "prime"},
             16)
    if b.prefix_stats["hits"] < 4:
        fail(f"serve-fp16: the chunked run took {b.prefix_stats}")
    log(f"  chunked (C=256) + prefix cache: 4 requests, prefix "
        f"{b.prefix_stats}; paged_decode_rows_f16 "
        f"{counts.get('paged_decode_rows_f16', 0)} launches")
    # tree speculation from the int4 draft model (4 slots, k=4)
    tree = offramp_tree(4)
    sreqs = [Request(uid=f"s{i}", prompt=(rng.randint(1, vocab, 8).tolist()
                                          * 4), max_new_tokens=16)
             for i in range(4)]
    sb = spec_batcher(model, 32, 4, tree=tree, slots=4, page_size=16,
                      draft=draft_source(model, 4, tree, slots=4))
    comps, counts = run("tree", lambda: sb.run(sreqs))
    complete("tree", comps, 16)
    st = sb.spec_stats
    log(f"  offramp_tree(4), int4 draft model: {st['committed']} tokens in "
        f"{st['steps']} verify steps, {st['accepted']} of {st['drafted']} "
        f"drafts accepted; tree {counts.get('paged_decode_tree_f16', 0)}, "
        f"int4 {counts.get('dequant_int4_f16', 0)} launches")
    # the fp16 logits against the same weights at fp32 compute
    ref = fp32_copy(model)
    toks = torch.as_tensor([reqs[3].prompt], device=dev)
    with torch.no_grad():
        lo = model.apply(toks)[0].float()
        hi = ref.apply(toks)[0]
    if not torch.isfinite(lo).all():
        fail("serve-fp16: non-finite fp16 logits")
    band = (lo - hi).abs().max().item()
    agree = (lo.argmax(-1) == hi.argmax(-1)).float().mean().item()
    log(f"  fp16 (O2) vs fp32 logits over a {toks.shape[1]}-token prompt: "
        f"max |diff| {band:.4f} (logit scale {hi.abs().max().item():.3f}), "
        f"argmax agrees at {100 * agree:.1f}% of positions")
    del ref, model
    torch.cuda.empty_cache()
    # the Llama mode at O2: one prompt past 2048 tokens
    llama = o2_model(LLAMA, dev, seed=4)
    prompt = np.random.RandomState(9).randint(1, vocab, 2300).tolist()
    (comps, wall, prefill_s, _), counts = run("llama", lambda: serve(
        llama, [Request(uid="long", prompt=prompt, max_new_tokens=16)],
        2304, 64, 1, 37))
    complete("Llama", comps, 16)
    log(f"  Llama mode O2, a 2300-token prompt (prefill padded to 2304): "
        f"prefill {1e3 * prefill_s[0]:.2f} ms, 16 tokens in {wall:.3f} s; "
        f"flash_fwd_f16 {counts.get('flash_fwd_f16', 0)}, paged_decode_f16 "
        f"{counts.get('paged_decode_f16', 0)} launches")
    for name in ("flash_fwd_f16", "paged_decode_f16"):
        if counts.get(name, 0) <= 0:
            fail(f"serve-fp16: the Llama run never launched {name}")
    del llama
    torch.cuda.empty_cache()
    log("  launches of the fp16 serving instances: " + ", ".join(
        f"{n} {total.get(n, 0)}" for n in SERVE_F16))
    idle = [n for n in SERVE_F16 if total.get(n, 0) <= 0]
    if idle:
        fail(f"serve-fp16: never launched {idle}")
    return total


def fp32_copy(model):
    """``model``'s weights at fp32 compute and parameters."""
    from apex_tpu_torch.models import GPTModel

    cfg = dataclasses.replace(model.config, policy=None,
                              params_dtype=torch.float32,
                              compute_dtype=torch.float32)
    ref = GPTModel(cfg, device=model.device)
    ref.load_state_dict({n: t.float() for n, t in
                         model.state_dict().items()})
    return ref


def device_rows(prof) -> list:
    """``(device us, calls, name)`` of each kernel and device copy in a
    ``torch.profiler`` run: an aten op's own entry repeats the device
    time of the kernels it launched, and a user annotation on the device
    timeline (``tlm.*`` phases, ``Optimizer.step#...``) spans the
    kernels inside it, so neither is counted."""
    from apex_tpu_torch.telemetry import PHASE_PREFIX

    rows = []
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.key.startswith(PHASE_PREFIX)
                or e.key.startswith("Optimizer.")):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0:
            rows.append((t, e.count, e.key))
    return rows


def device_breakdown(prof, wall_s: float, label: str) -> None:
    """Device busy share and the kernels that took the device's time,
    from a ``torch.profiler`` run of ``wall_s`` seconds."""
    rows = device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    if busy_us == 0:
        log(f"  {label}: device time not measured (the profiler saw none)")
        return None
    log(f"  {label}: wall {1e3 * wall_s:.2f} ms under the profiler, "
        f"device busy {busy_us / 1e3:.2f} ms = "
        f"{100 * busy_us / (1e6 * wall_s):.1f}% (idle "
        f"{100 - 100 * busy_us / (1e6 * wall_s):.1f}%)")
    for t, n, key in sorted(rows, reverse=True)[:8]:
        log(f"    {100 * t / busy_us:5.1f}% {t / 1e3:8.3f} ms {n:6d} calls "
            f"{key[:90]}")
    return busy_us / (1e6 * wall_s)


# ---------------------------------------------------------------- phase 5
def phase_profile(model, prompt=256, width=512, pps=9,
                  what="flagship GPT", weight_dtype=None,
                  kv_dtype=None) -> dict:
    """Where the serving time goes: 4 prefills of ``prompt``-token
    prompts (padded to ``width``), then one harvest window of 8 decode
    steps over 4 slots, replayed (after a 3-token request on the same
    batcher captured the step) and eager, each under ``torch.profiler``,
    with the weights of ``decode_fns(weight_dtype=)`` and the pages of
    ``kv_dtype``.  Returns each decode window's device busy share."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.serving import (
        ContinuousBatcher, KVCacheConfig, PagedKVCache, Request,
        init_pools)

    log(f"[profile] {what}, bf16: 4 prefills ({prompt} tokens, padded to "
        f"{width}), then 8 decode steps x 4 slots, replayed and eager")
    c = model.config
    ccfg = KVCacheConfig(
        num_layers=c.num_layers, num_heads=c.num_attention_heads,
        head_dim=c.head_dim, num_pages=1 + 4 * pps, page_size=64, max_seqs=4,
        pages_per_seq=pps, dtype=c.compute_dtype, kv_dtype=kv_dtype)
    fns = model.decode_fns(ccfg, max_prompt_len=width,
                           weight_dtype=weight_dtype)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    busy = {}
    for mode in ("replayed", "eager"):
        batcher = ContinuousBatcher(
            fns.prefill, fns.decode if mode == "replayed" else
            fns.decode_eager, PagedKVCache(ccfg),
            init_pools(ccfg, model.device), max_prompt_len=width,
            harvest_every=8)
        batcher.run([Request(uid="warm", prompt=[1, 2, 3],
                             max_new_tokens=3)])
        rng = np.random.RandomState(1)
        queue = collections.deque(
            Request(uid=i,
                    prompt=rng.randint(1, c.vocab_size, prompt).tolist(),
                    max_new_tokens=17) for i in range(4))
        for label, step in (("prefill x4", lambda: batcher._admit(queue)),
                            (f"decode x8, {mode}", batcher._decode_window)):
            if mode == "eager" and label == "prefill x4":
                step()              # profiled once, with the replayed run
                continue
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            share = device_breakdown(prof, wall, label)
            if label.startswith("decode"):
                busy[mode] = (share, wall / 8)
    return busy


# ---------------------------------------------------------------- phase 6
def step_of(model, opt, batch, rng=None):
    """One step, loss -> backward -> FusedAdam (``rng``: the dropout key
    ``GPTModel.loss`` takes): ``(loss, {name: grad}, {name: param after})``
    on the CPU."""
    opt.zero_grad(set_to_none=True)
    loss = model.loss(*batch) if rng is None else model.loss(*batch, rng=rng)
    loss.backward()
    grads = {n: p.grad.detach().cpu().clone()
             for n, p in model.named_parameters()}
    opt.step()
    return (loss.item(), grads,
            {n: p.detach().cpu().clone() for n, p in model.named_parameters()})


def check_step(label, gpu, cpu, before, lr, loss_tol: float = 1e-5,
               grad_tol: float = 1e-4) -> tuple:
    """Hold one training step on the GPU against the same step on a CPU
    copy (fp32 both): ``gpu``/``cpu`` are ``(loss, {name: grad}, {name:
    param after the step})``.  The loss to ``loss_tol`` (1e-5), every
    gradient to ``grad_tol`` (1e-4) of its tensor's largest, the updated
    parameters to 1% of a step where the gradient's sign is sure and
    within a step of where they were elsewhere.  Returns ``(worst grad
    error, worst step error, elements checked)``, each error as a share
    of its tolerance."""
    (lg, gg, pg), (lc, gc, pc) = gpu, cpu
    if not abs(lg - lc) <= loss_tol * max(1.0, abs(lc)):
        fail(f"{label}: loss {lg} (GPU) vs {lc} (CPU)")
    worst_g, worst_p, steps_checked = 0.0, 0.0, 0
    for n in gc:
        # fp32 on both sides, sums in another order: by default 1e-4 of
        # the tensor's largest gradient
        tol = grad_tol * gc[n].abs().max().item() + 1e-9
        err = (gg[n] - gc[n]).abs().max().item()
        worst_g = max(worst_g, err / tol)
        if err > tol:
            fail(f"{label}: grad {n} differs by {err:.3g} > {tol:.3g}")
        # the first Adam step moves a weight by lr * g / (|g| + eps):
        # where |g| is 10x the gradient tolerance and 1e-6 the sign
        # is sure and the steps agree to 1% of lr; elsewhere (noise,
        # such as the key bias's exactly-zero gradient) only the
        # bound |step| <= lr holds
        sure = gc[n].abs() >= max(10 * tol, 1e-6)
        dp = (pg[n] - pc[n]).abs()
        steps_checked += int(sure.sum())
        if sure.any():
            worst_p = max(worst_p, dp[sure].max().item() / (1e-2 * lr))
        if (dp[sure] > 1e-2 * lr).any() or (
                (pg[n] - before[n]).abs().max() > 1.001 * lr):
            fail(f"{label}: updated {n} differs by {dp.max().item():.3g}")
    return worst_g, worst_p, steps_checked


def phase_train_parity(dev, drop: float = 0.0,
                       seqs=(384, 640, 2560)) -> dict:
    """One training step (loss, backward, FusedAdam) at the flagship's
    width, 2 layers and fp32, on the GPU through the kernels and on a
    CPU copy of the same model and state through the plain versions
    (``device="cpu"``, chosen explicitly), batch 1: the flagship at s=384
    (short rung) and s=640 (mid rung), the Llama mode at s=2560 (flash
    rung).  With ``drop`` (train-dropout-parity) both copies take hidden
    and attention dropout at that rate and the same key, so the same
    masks, through the kernels' dropout instances and the hidden-dropout
    kernel on the GPU.  Returns each case's launch counts."""
    from apex_tpu_torch.amp import get_policy
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.random import PRNGKey, fold_in

    lr = 1e-3
    label = "train-dropout-parity" if drop else "train-parity"
    log(f"[{label}] flagship width, 2 layers, fp32 (O0): one step on "
        f"the GPU vs the CPU, FusedAdam lr={lr}"
        + (f", hidden and attention dropout {drop}" if drop else ""))
    rates = dict(hidden_dropout=drop, attention_dropout=drop)
    flagship = GPTConfig(**dict(FLAGSHIP, num_layers=2),
                         policy=get_policy("O0"), **rates)
    llama = GPTConfig(**dict(LLAMA, num_layers=2), policy=get_policy("O0"),
                      **rates)
    tag = "_drop" if drop else ""
    counts = {}
    for s, cfg, need in ((384, flagship, ("short_fwd", "short_bwd")),
                         (640, flagship, ("mid_fwd", "mid_bwd")),
                         (2560, llama, ("flash_fwd", "flash_bwd_dkv",
                                        "flash_bwd_dq"))):
        if s not in seqs:
            continue
        need = tuple(n + tag for n in need) + (("dropout",) if drop else ())
        rng = fold_in(PRNGKey(11), s) if drop else None
        gpu = GPTModel(cfg, device=dev, seed=3)
        cpu = GPTModel(cfg, device="cpu", seed=3)
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        before = {k: v.cpu().clone() for k, v in gpu.state_dict().items()}
        toks = np.random.RandomState(s).randint(0, cfg.vocab_size, (1, s))
        tgts = np.roll(toks, -1, axis=1)
        out = []
        for model in (gpu, cpu):
            opt = FusedAdam(model.parameters(), lr=lr)
            batch = [torch.as_tensor(a, device=model.device)
                     for a in (toks, tgts)]
            if model is gpu:
                torch.cuda.synchronize()
                reset_launch_counts()
            out.append(step_of(model, opt, batch, rng))
            if model is gpu:
                torch.cuda.synchronize()
                counts[s] = launch_counts()
        worst_g, worst_p, steps_checked = check_step(
            f"{label} s={s}", *out, before, lr)
        c = counts[s]
        log(f"  s={s} ({cfg.position_embedding}, {cfg.activation}): loss "
            f"{out[0][0]:.6f} (GPU) vs {out[1][0]:.6f} (CPU); every grad "
            f"within 1e-4 of its scale (worst {worst_g:.3f} of the "
            f"tolerance); updated params within 1% of a step at "
            f"{steps_checked} sure-sign elements (worst {worst_p:.3f} of "
            f"it); launches {({k: v for k, v in c.items() if v})}")
        for name in need + LN_TRAIN:
            if c.get(name, 0) <= 0:
                fail(f"{label} s={s}: kernel {name} never launched")
        del gpu, cpu
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- phase 7
#: the trainer flags of the two training cells (the JAX trainer's defaults
#: are vocab 32768, 12 layers, hidden 1024, 8 heads)
TRAIN_FLAGSHIP = ["--seq", "1024", "--micro-batch", "8", "--num-micro", "1"]
TRAIN_LONG = ["--position-embedding", "rope", "--activation", "swiglu",
              "--normalization", "rmsnorm", "--seq", str(LONG_SEQ),
              "--micro-batch", "2", "--num-micro", "1"]


#: each training phase's figures by label, for the summary lines
TRAIN_SUMMARY = {}


def phase_train(dev, flags=TRAIN_FLAGSHIP, label="train",
                need=LN_TRAIN + ("mid_fwd", "mid_bwd", "multi_tensor_adam"),
                opt_level="O5"):
    """A 12-layer GPT at ``opt_level`` (O5: bf16 params and compute, fp32
    norms and masters; O2: the same in fp16 with the dynamic loss scaler),
    remat on, through the port trainer's step as ``gpt_pretrain <flags>
    --opt-level <opt_level>`` builds it (the flagship, 8 x 1024 tokens, by
    default): 2 warm-up steps, then 10 timed steps on a repeated batch;
    the kernels in ``need`` must have launched.  With a loss scaler every
    skipped step (its gradients not finite) is printed."""
    from apex_tpu_torch.amp import get_policy
    from apex_tpu_torch.examples import gpt_pretrain
    from apex_tpu_torch.models import GPTModel
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.telemetry import mfu

    args = gpt_pretrain.parse_args(flags + [
        "--opt-level", opt_level, "--lr", "3e-4", "--device", str(dev)])
    log(f"[{label}] gpt_pretrain {' '.join(flags)}: {args.layers} layers, "
        f"{opt_level}, remat on, 2 warm-up + 10 timed steps of the port "
        "trainer on one batch")
    tr = gpt_pretrain.Trainer(args)
    batch = tr.to_device(*gpt_pretrain.batches(
        np.random.default_rng(0), 1, tr.global_batch, args.seq,
        args.vocab)[0])
    # bf16 vs fp32 loss at step 1 from the same weights
    ref = GPTModel(dataclasses.replace(tr.model.config,
                                       policy=get_policy("O0")), device=dev)
    ref.load_state_dict({k: v.float() for k, v in
                         tr.model.state_dict().items()})
    with torch.no_grad():
        loss_fp32 = ref.loss(*batch).item()
    del ref
    torch.cuda.empty_cache()
    finite = []

    def step():
        loss = tr.step(*batch)
        if tr.finite is not None:
            finite.append(tr.finite)
        return loss

    warm = [step() for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    losses = [step() for _ in range(10)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    skipped = [i + 1 for i, f in enumerate(finite) if not bool(f)]
    losses = [float(x) for x in torch.stack(warm + losses).cpu()]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[2] < losses[0]:
        fail(f"{label}: losses {losses} are not finite and falling")
    ms = 1e3 * wall / 10
    tps = tr.tokens_per_step / (ms / 1e3)
    util = mfu(tps, tr.flops_per_token, PEAK_OPS_PER_S[torch.bfloat16])
    log(f"  step 1 loss: {losses[0]:.5f} at {opt_level} vs {loss_fp32:.5f} "
        f"at fp32 from the same weights (|diff| "
        f"{abs(losses[0] - loss_fp32):.5f})")
    log(f"  losses: {' '.join(f'{x:.4f}' for x in losses)}")
    if tr.use_scaler:
        scale = float(tr.amp_state.scaler_states[0].loss_scale)
        log(f"  skipped steps (of the 12): {skipped or 'none'}; loss scale "
            f"{scale:g} after the last")
    log(f"  {ms:.2f} ms/step, {tps:,.0f} tokens/s, MFU {util:.4f} against "
        f"the 989 TFLOP/s bf16 dense peak ({tr.n_params:,} params, the "
        f"SwiGLU gate included where there is one; {tr.flops_per_token:,} "
        f"model FLOPs per token, 6·N + 12·L·h·s at s={args.seq})")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  peak device memory {peak:.2f} GiB")
    TRAIN_SUMMARY[label] = dict(level=opt_level, ms=ms, tps=tps, mfu=util,
                                peak_gib=peak, skipped=skipped)
    log(f"  launches in the 10 timed steps: {counts} (per step: "
        + ", ".join(f"{k} {v / 10:g}" for k, v in sorted(counts.items()))
        + ")")
    for name in need:
        if counts.get(name, 0) <= 0:
            fail(f"{label}: kernel {name} never launched on the main path")
    return counts, tr, batch


def phase_profile_train(tr, batch, what="flagship (O5, 8 x 1024)") -> None:
    """Where a training step's time goes: one step under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    log(f"[profile] one training step, {what}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.step(*batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_breakdown(prof, wall, "train step")
    log(f"  by kind: {attention_share(prof)}")
    host = [e for e in prof.key_averages()
            if e.key.startswith("Optimizer.step")
            and e.device_type == torch.autograd.DeviceType.CPU]
    if host:
        log(f"  host time inside {host[0].key}: "
            f"{host[0].cpu_time_total / 1e3:.2f} ms")
    else:
        log("  host time inside the optimizer step: not measured (no "
            "Optimizer.step record)")
    tail = [(t, n, key) for t, n, key in device_rows(prof)
            if is_tail_kernel(key)]
    log(f"  device time of the multi-tensor kernels: "
        f"{sum(t for t, _, _ in tail) / 1e3:.3f} ms in "
        f"{sum(n for _, n, _ in tail)} launches"
        + "".join(f"; {t / 1e3:.3f} ms {n} x {key[:60]}"
                  for t, n, key in sorted(tail, reverse=True)[:4]))


def phase_train_dropout(dev, base=FLAGSHIP, seq=1024, micro=8, steps=10,
                        label="train-dropout",
                        need=("mid_fwd_drop", "mid_bwd_drop")):
    """A 12-layer GPT at O5, remat on, with ``hidden_dropout =
    attention_dropout = DROP_RATE`` (Megatron-LM's and GPT-2's 0.1),
    built as the port trainer builds it (``gpt_pretrain``'s seed-0
    weights, ``FusedAdam`` with fp32 masters, lr 3e-4), stepped as
    ``GPTModel.loss(tokens, targets, rng=fold_in(base, step))`` ->
    backward -> ``FusedAdam`` (the JAX trainer has no dropout flag, so
    neither has the port's): 2 warm-up and ``steps`` timed steps on one
    batch.  The loss must be finite and end below its start; the step-1
    loss at O5 must sit within 0.02 of fp32's from the same weights and
    key (the same masks); the dropout kernel and the kernels in ``need``
    must launch.  Returns ``(counts, step, batch)``."""
    from apex_tpu_torch.amp import get_policy
    from apex_tpu_torch.examples import gpt_pretrain
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.random import PRNGKey, fold_in
    from apex_tpu_torch.telemetry import mfu
    from apex_tpu_torch.telemetry.metrics import transformer_flops_per_token

    cfg = GPTConfig(**dict(base, max_position_embeddings=seq),
                    policy=get_policy("O5"), hidden_dropout=DROP_RATE,
                    attention_dropout=DROP_RATE)
    log(f"[{label}] {cfg.num_layers} layers, O5, remat on, {micro} x {seq} "
        f"tokens, hidden and attention dropout {DROP_RATE}, a key "
        f"fold_in(base, step) a step: 2 warm-up + {steps} timed steps of "
        "GPTModel.loss(rng=) -> backward -> FusedAdam on one batch")
    model = GPTModel(cfg, device=dev, seed=0)
    opt = FusedAdam(model.parameters(), lr=3e-4, master_weights=True)
    batch = [torch.as_tensor(a, device=dev) for a in gpt_pretrain.batches(
        np.random.default_rng(0), 1, micro, seq, cfg.vocab_size)[0]]
    base_key = PRNGKey(2024)
    # bf16 vs fp32 loss at step 1: the same weights, key and masks
    ref = GPTModel(dataclasses.replace(cfg, policy=get_policy("O0")),
                   device=dev)
    ref.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
    with torch.no_grad():
        loss_fp32 = ref.loss(*batch, rng=fold_in(base_key, 0)).item()
    del ref
    torch.cuda.empty_cache()

    def step(i):
        opt.zero_grad(set_to_none=True)
        loss = model.loss(*batch, rng=fold_in(base_key, i))
        loss.backward()
        opt.step()
        return loss.detach()

    warm = [step(i) for i in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    losses = [step(i) for i in range(2, 2 + steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    losses = [float(x) for x in torch.stack(warm + losses).cpu()]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"{label}: losses {losses} are not finite or do not end below "
             "their start")
    if not abs(losses[0] - loss_fp32) <= 0.02:
        fail(f"{label}: step-1 loss {losses[0]} at O5 vs {loss_fp32} at fp32")
    n_params = sum(p.numel() for p in model.parameters())
    flops = transformer_flops_per_token(n_params, cfg.num_layers,
                                        cfg.hidden_size, seq)
    ms = 1e3 * wall / steps
    tps = micro * seq / (ms / 1e3)
    util = mfu(tps, flops, PEAK_OPS_PER_S[torch.bfloat16])
    log(f"  step 1 loss: {losses[0]:.5f} at O5 vs {loss_fp32:.5f} at fp32 "
        f"from the same weights and masks (|diff| "
        f"{abs(losses[0] - loss_fp32):.5f}, limit 0.02)")
    log(f"  losses: {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"  {ms:.2f} ms/step, {tps:,.0f} tokens/s, MFU {util:.4f} against "
        f"the 989 TFLOP/s bf16 dense peak ({n_params:,} params; {flops:,} "
        "model FLOPs per token, the numerator without dropout)")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        " GiB")
    log(f"  launches in the {steps} timed steps: "
        + ", ".join(f"{k} {v / steps:g}" for k, v in sorted(counts.items())
                    if v) + " a step")
    for name in need + LN_TRAIN + ("dropout",):
        if counts.get(name, 0) <= 0:
            fail(f"{label}: kernel {name} never launched on the main path")
    return counts, types.SimpleNamespace(step=lambda: step(2 + steps)), ()


def phase_seg_dropout(dev) -> dict:
    """``flash_attention`` with segment ids and dropout, forward and
    backward through autograd, at BERT-large's training shape (b=16 h=16
    s=512 d=64, BERT's key padding, bf16): the entry point contrib
    attention (ROADMAP.md queue A item 3) will call, on the short rung's
    ``_seg_drop`` instances, which must launch.  The output must be
    finite, and equal the plain path's to two bf16 ulps."""
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.ops.attention import flash_attention

    b, heads, s, d = 16, SEG_HEADS, 512, SEG_D
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v, dout = (torch.randn(b, heads, s, d, generator=gen, device=dev)
                     .to(torch.bfloat16).requires_grad_() for _ in range(4))
    qi, ki = segment_ids("bert", b, s, dev, seed=9)
    kw = dict(q_segment_ids=qi, kv_segment_ids=ki, dropout_rate=DROP_RATE,
              dropout_seed=DROP_SEED)
    log(f"[seg-dropout] flash_attention with segment ids and dropout "
        f"{DROP_RATE}, b={b} h={heads} s={s} d={d} bf16, forward and "
        "backward")
    torch.cuda.synchronize()
    reset_launch_counts()
    out = flash_attention(q, k, v, **kw)
    out.backward(dout.detach())
    torch.cuda.synchronize()
    counts = launch_counts()
    with torch.no_grad():
        from apex_tpu_torch.ops import attention_short as short

        want, _ = short._short_fwd_plain(
            q.detach(), k.detach(), v.detach(), False, d ** -0.5, qi, ki,
            (DROP_RATE, DROP_SEED))
    check("short_fwd_seg_drop", out.detach(), want, "entry point out")
    if not all(torch.isfinite(t.grad).all() for t in (q, k, v)):
        fail("seg-dropout: non-finite gradients")
    log(f"  launches: {({n: c for n, c in counts.items() if c})}")
    for name in ("short_fwd_seg_drop", "short_bwd_seg_drop"):
        if counts.get(name, 0) <= 0:
            fail(f"seg-dropout: kernel {name} never launched")
    return counts


# ------------------------------------------------------------------ bias
#: the additive-bias instances' shapes: (rung, b, h, sq, sk, d, causal,
#: the bias's broadcast, segment ids, dropout, the kernels timed at this
#: shape).  The short rung's are mha-train's decoder self-attention
#: (Transformer-big's 16 heads of 64 at 32 x 256, the future mask as a
#: shared bias): its pass without padding or dropout, and its training
#: pass with the key padding as ids and attention dropout 0.1; the mid and
#: flash ones are mha-rungs' widths with a per-batch and a shared bias.
#: The untimed ones hold the per-head broadcast on the short rung and have
#: ragged query and key tiles and sq < sk, causal: no bias may be read
#: past its (sq, sk) slab, and the dK/dV blocks of keys past every query
#: run no query tile.
BIAS_SHAPES = (
    ("short", 32, 16, 256, 256, 64, False, "shared", None, False,
     ("short_fwd_bias", "short_bwd_bias")),
    ("short", 8, 8, 512, 512, 128, True, "per_head", None, False, ()),
    ("mid", 8, 8, 1024, 1024, 128, True, "per_batch", None, False,
     ("mid_fwd_bias", "mid_bwd_bias")),
    ("flash", 2, 8, LONG_SEQ, LONG_SEQ, 128, True, "shared", None, False,
     tuple(n + "_bias" for n in ("flash_fwd", "flash_bwd_dkv",
                                 "flash_bwd_dq"))),
    ("short", 32, 16, 256, 256, 64, False, "shared", "bert", True,
     ("short_fwd_seg_drop_bias", "short_bwd_seg_drop_bias")),
    ("short", 3, 16, 250, 330, 64, True, "per_batch", None, False, ()),
    ("mid", 2, 4, 700, 900, 64, True, "per_head", None, True, ()),
    ("flash", 2, 4, 2100, 2470, 128, True, "shared", None, False, ()),
)
#: query rows the bias alone hides (every key at -1e30), in every case
BIAS_MASKED_ROWS = (5, 200)


def make_bias(kind: str, b: int, heads: int, sq: int, sk: int,
              causal: bool, randn, dev) -> torch.Tensor:
    """An fp32 bias of ``kind``'s broadcast: normal values when causal,
    the future mask as -1e30 otherwise (a boolean ``attn_mask`` made a
    bias, as contrib attention makes it), and the rows of
    :data:`BIAS_MASKED_ROWS` at -1e30 on every key."""
    lead = {"shared": (1, 1), "per_batch": (b, 1), "heads": (1, heads),
            "per_head": (b, heads)}
    shape = lead[kind] + (sq, sk)
    if causal:
        bias = randn(*shape)
    else:
        future = torch.ones(sq, sk, dtype=torch.bool, device=dev).triu(1)
        bias = torch.where(future, -1e30, 0.0).expand(shape).contiguous()
    bias[..., list(BIAS_MASKED_ROWS), :] = -1e30
    return bias


def bias_kernels(randn) -> dict:
    """The bias instances of the seven attention kernels (the Pallas
    bodies' ``has_bias``) at :data:`BIAS_SHAPES`, fp32 and bf16, each
    against its plain version with the same bias (the backward kernels
    get the plain forward's ``out`` and ``lse``); the rows the bias alone
    hides must read as the uniform mean of V over their visible keys (the
    cases without dropout).  Timed at bf16 beside the same kernel without
    the bias, the plain version and SDPA with the same float
    ``attn_mask``; the bound counts the bias read once per stored
    element."""
    records = {}
    log("[kernels] bias instances (CUDA): per-head, per-batch and shared "
        f"fp32 biases, rows {BIAS_MASKED_ROWS} hidden by the bias alone")
    for (rung, b, heads, sq, sk, d, causal, kind, ids_kind, dropped,
         timed_names) in BIAS_SHAPES:
        for dtype in (torch.float32,) + SM90_DTYPES:
            if dtype == torch.float16 and not timed_names:
                continue
            q, dout = (randn(b, heads, sq, d, dtype=dtype) for _ in range(2))
            k, v = (randn(b, heads, sk, d, dtype=dtype) for _ in range(2))
            ids = (segment_ids(ids_kind, b, sq, q.device, seed=sq + b)
                   if ids_kind else (None, None))
            drop = (DROP_RATE, DROP_SEED) if dropped else None
            bias = make_bias(kind, b, heads, sq, sk, causal, randn, q.device)
            run = variant_run(rung, q, k, v, dout, causal, ids, drop, bias)
            what = (f"{str(dtype)[6:]} b={b} h={heads} sq={sq} sk={sk} d={d} "
                    f"{kind}"
                    + (" ids" if ids_kind else "")
                    + (" dropout" if dropped else ""))
            errs = {}
            for name, label, got, want in run["checks"]:
                errs[name] = max(errs.get(name, 0.0),
                                 check(name, got, want, f"{what} {label}"))
            if not dropped and ids_kind is None:
                # a hidden row's p is exp(0) = 1 on each key the predicate
                # shows it: the mean of V over keys 0..i when causal, over
                # every key when not
                out = run["checks"][0][2]
                rows = list(BIAS_MASKED_ROWS)
                mean = (v.float().cumsum(2) / torch.arange(
                    1, sk + 1, device=v.device)[:, None])[:, :, rows] \
                    if causal else v.float().mean(2, keepdim=True)
                err = max_err(out[:, :, rows], mean)
                tol = tolerance(out[:, :, rows])
                if not err <= tol:
                    fail(f"{run['checks'][0][0]} {what}: a row the bias "
                         f"hides differs from the uniform mean by {err:.3g}"
                         f" > {tol:.3g}")
                log(f"  {what}: rows {rows} the bias hides read as the "
                    f"uniform mean of V (max_abs_err {err:.3g})")
            if dtype in SM90_DTYPES and timed_names:
                records.update(variant_records(
                    rung, b, heads, sq, d, causal, kind, q, k, v, dout, ids,
                    drop, run, errs, tuple(f16(n, dtype)
                                           for n in timed_names), bias))
            del q, k, v, dout, bias, run
    return records


# ------------------------------------------------------------- dBias
#: the dBias instances held in phase 2 (rung, b, heads, sq, sk, d, bias
#: kind, ids kind, dropout, the record timed at bf16 or None), every one
#: causal, the rows of :data:`BIAS_MASKED_ROWS` hidden by the bias alone:
#: dbias-train's four passes, then a causal sq < sk case a rung
DBIAS_SHAPES = (
    ("short", 32, 16, 256, 256, 64, "heads", None, False, "short_bwd_dbias"),
    ("short", 32, 16, 256, 256, 64, "heads", "bert", True,
     "short_bwd_seg_drop_dbias"),
    ("mid", 8, 8, 1024, 1024, 128, "shared", None, False, "mid_bwd_dbias"),
    ("flash", 2, 8, LONG_SEQ, LONG_SEQ, 128, "heads", None, False,
     "flash_bwd_dq_dbias"),
    ("short", 3, 16, 250, 330, 64, "per_batch", None, False, None),
    ("mid", 2, 4, 700, 900, 64, "per_batch", None, True, None),
    ("flash", 2, 4, 2100, 2470, 128, "per_head", None, False, None),
)
#: dBias kernel vs plain, with fp32 and bf16 inputs alike: both compute dz
#: = p * (dp - delta) in fp32 from the same inputs and fold it with the
#: same torch.sum; only the order of the products' sums differs, so each
#: element is held to 5e-5 of its row's scale (:func:`dbias_band`)
DBIAS_TOL = 5e-5


def dbias_band(want: torch.Tensor) -> torch.Tensor:
    """Each dBias element's tolerance: :data:`DBIAS_TOL` of its row's
    scale, the largest |dBias| of that row (the bias's last dim) or of the
    next row, and at least the median row's.  A row the bias alone hides
    (p = 1 on every key, so |dBias| = |dp - delta| runs to the hundreds)
    so sets the band of two rows, not the whole tensor's.  A row with one
    visible key (the first causal row) has dBias = dp - delta = 0 but for
    rounding, whose size is that of dp, not of its own |dBias|; the next
    row, two keys of the same magnitudes, gives that scale."""
    rows = want.float().abs().amax(-1, keepdim=True)
    after = torch.cat([rows[..., 1:, :], rows[..., -1:, :]], dim=-2)
    return DBIAS_TOL * torch.maximum(rows, after).clamp(
        min=rows.median().item())


def dbias_check(label: str, got, want) -> tuple:
    """Hold a dBias against its plain version element by element (each
    within its :func:`dbias_band`); ``(max_abs_err, the largest error as
    a share of its band, the median and the largest row scale)``."""
    band = dbias_band(want)
    err = (got.float() - want.float()).abs()
    share = (err / band).max().item()
    rows = want.float().abs().amax(-1)
    if not share <= 1.0:
        fail(f"{label}: dbias differs from the plain version by "
             f"{err.max().item():.3g}, {share:.3g} of its band ("
             f"{DBIAS_TOL:g} of each row's scale)")
    return (err.max().item(), share, rows.median().item(),
            rows.max().item())


def dbias_visible(b, heads, sq, sk, ids, dev):
    """``(visible, pairs)``: the causal pairs (and those of equal ids) as a
    bool mask broadcastable to ``(b, h, sq, sk)``, and their number over
    the batch and heads."""
    vis = torch.ones(sq, sk, dtype=torch.bool, device=dev).tril()
    if ids[0] is not None:
        vis = vis & (ids[0][:, :, None] == ids[1][:, None, :])[:, None]
        return vis, heads * int(vis.sum())
    return vis, b * heads * int(vis.sum())


def dbias_run(rung, q, k, v, dout, ids, drop, bias) -> dict:
    """One rung's dBias instance on ``(b, h, sq, d)`` inputs, causal:
    ``kernel``, the backward entry with ``bias_grad=True`` (the short and
    mid ones give ``(dq, dk, dv, dbias)``, the flash dQ entry ``(dq,
    dbias)``, the bias's gradient folded into its shape); ``base``, the
    same call without it (the bias instance); ``plain``, the plain
    backward and the same fold.  The backward calls take the plain
    forward's ``out`` and ``lse``."""
    from apex_tpu_torch.ops import attention_flash as fl
    from apex_tpu_torch.ops import attention_mid as mid
    from apex_tpu_torch.ops import attention_short as short

    b, heads, sq, d = q.shape
    sk = k.shape[2]
    scale = d ** -0.5
    qi, ki = ids
    slab = short.bias_slab("bias", bias, b, heads, sq, sk)
    kw = dict(q_segment_ids=qi, kv_segment_ids=ki, bias=bias)
    if drop:
        kw.update(dropout_rate=drop[0], dropout_seed=drop[1])
    fold = lambda g: short.fold_bias_grad(g.view(b, heads, sq, sk),
                                          bias.shape, bias.dtype)
    if rung == "flash":
        flat = [t.reshape(b * heads, -1, d) for t in (q, k, v, dout)]
        out, lse = fl._flash_fwd_plain(*flat[:3], True, scale, qi, ki,
                                       heads, drop, slab)
        delta = fl.flash_delta(out, flat[3])
        call = lambda **x: fl.flash_bwd_dq(*flat, lse, delta, True,
                                           heads=heads, **kw, **x)

        def plain():
            dq, _, _, dz = fl._flash_bwd_plain(*flat, lse, delta, True, scale,
                                               qi, ki, heads, drop, slab, True)
            return dq, fold(dz)

        names = ("dq", "dbias")
    else:
        bwd = short.short_bwd if rung == "short" else mid.mid_bwd
        out, lse = short._short_fwd_plain(q, k, v, True, scale, qi, ki, drop,
                                          slab)
        call = lambda **x: bwd(q, k, v, out, dout, lse, None, True, **kw, **x)

        def plain():
            *grads, dz = short._short_bwd_plain(q, k, v, out, dout, lse, None,
                                                True, scale, qi, ki, drop,
                                                slab, True)
            return (*grads, fold(dz))

        names = ("dq", "dk", "dv", "dbias")
    return dict(kernel=lambda: call(bias_grad=True), base=lambda: call(),
                plain=plain, names=names)


def dbias_kernels(randn) -> dict:
    """The dBias instances of the short/mid and flash dQ kernels (the
    Pallas bodies' dbias output) at :data:`DBIAS_SHAPES`, fp32 and bf16,
    each held against its plain version with the same bias: dq (dk, dv)
    as phase 2 holds them, the bias's gradient in its own shape element
    by element to :data:`DBIAS_TOL` of its row's scale (:func:`dbias_band`)
    for fp32 and bf16 inputs alike, and bit for bit from one call to the
    next (no atomics).  The timed ones at bf16 beside the bias
    instance without dBias, the plain version and SDPA forward+backward
    with a float ``attn_mask`` that requires grad; the bound is the
    backward's (phase 2's bias rows) plus each bias element a visible
    pair reads, once, and each dBias element of the bias's own shape
    written once, 4 bytes each."""
    import torch.nn.functional as F
    from apex_tpu_torch.ops import attention_short as short

    records = {}
    log("[kernels] dBias instances (CUDA): the short/mid and flash dQ "
        "kernels' DBIAS instances, causal, (1, h), per-batch, per-head and "
        f"shared fp32 biases, rows {BIAS_MASKED_ROWS} hidden by the bias")
    for (rung, b, heads, sq, sk, d, kind, ids_kind, dropped,
         timed_name) in DBIAS_SHAPES:
        for dtype in (torch.float32,) + SM90_DTYPES:
            if dtype == torch.float16 and not timed_name:
                continue
            q, dout = (randn(b, heads, sq, d, dtype=dtype) for _ in range(2))
            k, v = (randn(b, heads, sk, d, dtype=dtype) for _ in range(2))
            ids = (segment_ids(ids_kind, b, sq, q.device, seed=sq + b)
                   if ids_kind else (None, None))
            drop = (DROP_RATE, DROP_SEED) if dropped else None
            bias = make_bias(kind, b, heads, sq, sk, True, randn, q.device)
            run = dbias_run(rung, q, k, v, dout, ids, drop, bias)
            what = (f"{str(dtype)[6:]} b={b} h={heads} sq={sq} sk={sk} d={d} "
                    f"{kind} {tuple(bias.shape)}"
                    + (" ids" if ids_kind else "")
                    + (" dropout" if dropped else ""))
            name = ("flash_bwd_dq" if rung == "flash" else f"{rung}_bwd") + \
                short.counter(("", "_seg"), ids_kind is not None, drop, bias,
                              True, dtype == torch.float16)
            got, again, want = run["kernel"](), run["kernel"](), run["plain"]()
            err = 0.0
            for label, g, w in zip(run["names"][:-1], got, want):
                err = max(err, check(name, g, w, f"{what} {label}"))
            db_err, share, median, top = dbias_check(
                f"{name} {what}", got[-1], want[-1])
            if not torch.equal(got[-1], again[-1]):
                fail(f"{name} {what}: dbias differs between two calls")
            log(f"  {name} {what} dbias: max_abs_err {db_err:.3g}, "
                f"{share:.3g} of its band ({DBIAS_TOL:g} of each row's "
                f"largest |dbias|: {median:.3g} the median row's, {top:.3g} "
                "the largest), the same bits on a second call")
            if dtype in SM90_DTYPES and timed_name:
                assert name == f16(timed_name, dtype), (name, timed_name)
                records[name] = [dbias_record(
                    rung, name, q, k, v, dout, ids, bias, run, max(err, db_err),
                    what, F)]
            del q, k, v, dout, bias, run, got, again, want
    torch.cuda.empty_cache()
    return records


def dbias_record(rung, name, q, k, v, dout, ids, bias, run, err, what,
                 F) -> dict:
    """Time one dBias instance (bf16): the entry with ``bias_grad=True``
    (the backward kernels and the fold) beside the bias instance without
    dBias, the plain version and SDPA forward+backward with the same float
    mask requiring grad (profiled; None, with the reason, if SDPA will not
    take it)."""
    from apex_tpu_torch.ops import attention_short as short

    b, heads, sq, d = q.shape
    sk = k.shape[2]
    vis, pairs = dbias_visible(b, heads, sq, sk, ids, q.device)
    numel = q.numel() * q.element_size()
    rows = b * heads * sq * 4
    id_bytes = 0 if ids[0] is None else 2 * ids[0].numel() * 4
    if rung == "flash":
        nbytes, ops = 5 * numel + 2 * rows + id_bytes, 6.0 * d * pairs
    else:
        nbytes, ops = 8 * numel + rows + id_bytes, 10.0 * d * pairs
    nbytes += bias_read_bytes(short.bias_slab("bias", bias, b, heads, sq, sk),
                              vis) + 4 * bias.numel()
    rec = measure(name, what + " causal", err, run["kernel"], run["plain"],
                  None, nbytes=nbytes, ops=ops, dtype=q.dtype,
                  plain_iters=10 if rung == "flash" else 50)
    base_ms, _ = time_ms(run["base"], 10 if rung == "flash" else 50)
    rec["ms_without_dbias"] = base_ms
    log(f"  {name}: {rec['ms'] / base_ms:.3f}x the bias instance without "
        f"dBias ({base_ms:.4f} ms) at this shape")
    p = 0.0 if "drop" not in name else DROP_RATE
    mask = bias.masked_fill(~vis, float("-inf")).to(q.dtype).requires_grad_()
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                           dropout_p=p)
        torch.autograd.grad(o, (qg, kg, vg, mask), dout)

    try:
        rec["library_ms"] = profiled_ms(sdpa_fwd_bwd)
        log(f"  {name}: library call is SDPA (float mask {tuple(mask.shape)}"
            f" that requires grad) forward+backward, "
            f"{rec['library_ms']:.4f} ms of device time (profiler), which "
            "includes a forward")
    except RuntimeError as exc:
        rec["library_ms"] = None
        log(f"  {name}: no library time: SDPA refused a float mask that "
            f"requires grad at this shape ({str(exc).splitlines()[0]})")
    del mask, qg, kg, vg
    return rec


# ------------------------------------------------- contrib attention phases
#: Transformer-big (Vaswani et al. 2017, Table 3): d_model 1024, 16 heads
#: of 64, attention dropout 0.1; the widths the reference's own
#: multihead_attn tests run.  A batch of 32 x 256 target tokens (8192) and
#: 320 source tokens a row
MHA_EMBED, MHA_HEADS, MHA_DROPOUT = 1024, 16, 0.1
MHA_BATCH, MHA_SEQ, MHA_SRC = 32, 256, 320
#: timed forward+backward passes a module in mha-train (after 3 warm-up)
MHA_PASSES = 20


def mha_grads(m, inputs, dout, **kw):
    """``(out, {name: grad}, [input grads])`` of one forward and backward
    of module ``m``, on the CPU."""
    xs = [x.detach().clone().requires_grad_() for x in inputs]
    m.zero_grad(set_to_none=True)
    out = m(*xs, **kw)
    out.backward(dout)
    return (out.detach().cpu(),
            {n: p.grad.detach().cpu() for n, p in m.named_parameters()},
            [x.grad.detach().cpu() for x in xs])


def check_mha(label, got, want) -> float:
    """Hold one module's forward and backward against another's run of
    the same weights and key, with phase 6's tolerances: the output to
    1e-4 of its scale, every gradient (parameters and inputs) to 1e-4 of
    its tensor's largest.  Returns the worst error as a share of its
    tolerance."""
    worst = max_err(got[0], want[0]) / tolerance(want[0])
    pairs = [(n, got[1][n], want[1][n]) for n in want[1]] + [
        (f"input {i}", g, w) for i, (g, w) in enumerate(zip(got[2], want[2]))]
    for name, g, w in pairs:
        tol = 1e-4 * w.abs().max().item() + 1e-9
        err = max_err(g, w)
        worst = max(worst, err / tol)
        if not err <= tol:
            fail(f"{label}: grad of {name} differs by {err:.3g} > {tol:.3g}")
    if worst > 1.0:
        fail(f"{label}: output differs by {worst:.3g} of its tolerance")
    return worst


def phase_mha_parity(dev) -> dict:
    """``SelfMultiheadAttn`` and ``EncdecMultiheadAttn`` at small widths
    (embed 128, 2 heads of 64), fp32, with every option: ``bias``,
    ``include_norm_add``, a boolean and a float ``attn_mask``,
    ``key_padding_mask``, ``causal`` and dropout 0.2 with a key.  Each
    module's forward and backward on the GPU (``impl="fast"``, the
    kernels) must equal its CPU copy's (the plain versions) with the same
    weights and key, output and the gradients of every parameter and
    input; on the GPU ``impl="fast"`` must equal ``impl="default"``, the
    reference's own cross-check.  Returns the launches of the GPU runs."""
    from apex_tpu_torch.contrib.multihead_attn import (
        EncdecMultiheadAttn, SelfMultiheadAttn)
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.random import PRNGKey

    e, heads, s, b, src = 128, 2, 96, 3, 80
    log(f"[mha-parity] embed {e}, {heads} heads, b={b}, s={s} (source "
        f"{src}), fp32: GPU vs CPU, and fast vs default on the GPU")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(s, b, e, generator=gen)
    mem = torch.randn(src, b, e, generator=gen)
    future = torch.ones(s, s, dtype=torch.bool).triu(1)
    float_mask = 0.5 * torch.randn(b, 1, s, s, generator=gen)
    head_mask = 0.5 * torch.randn(b, heads, s, s, generator=gen)
    pad = torch.zeros(b, s, dtype=torch.bool)
    pad[1, 2 * s // 3:] = True
    src_pad = torch.zeros(b, src, dtype=torch.bool)
    src_pad[2, src // 2:] = True
    key = PRNGKey(21)
    cases = (  # (label, module class, options, inputs, forward keywords)
        ("self, bias, norm-add, boolean future mask", SelfMultiheadAttn,
         dict(bias=True, include_norm_add=True), (x,),
         dict(attn_mask=future)),
        ("self, float mask (b, 1, s, s), padding, dropout",
         SelfMultiheadAttn, dict(dropout=0.2), (x,),
         dict(attn_mask=float_mask, key_padding_mask=pad, rng=key)),
        ("self, per-head float mask, dropout", SelfMultiheadAttn,
         dict(dropout=0.2, bias=True), (x,),
         dict(attn_mask=head_mask, rng=key)),
        ("self, causal, padding, dropout, norm-add", SelfMultiheadAttn,
         dict(dropout=0.2, include_norm_add=True), (x,),
         dict(causal=True, key_padding_mask=pad, rng=key)),
        ("encdec, bias, norm-add, padding, dropout", EncdecMultiheadAttn,
         dict(dropout=0.2, bias=True, include_norm_add=True), (x, mem),
         dict(key_padding_mask=src_pad, rng=key)),
    )
    counts = {}
    for label, cls, opts, inputs, kw in cases:
        gpu = cls(e, heads, device=dev, key=PRNGKey(3), **opts)
        cpu = cls(e, heads, device="cpu", **opts)
        cpu.load_state_dict({n: t.cpu() for n, t in gpu.state_dict().items()})
        dout = torch.randn(s, b, e, generator=gen)
        on = lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t
        torch.cuda.synchronize()
        reset_launch_counts()
        got = mha_grads(gpu, [on(t) for t in inputs], on(dout),
                        **{n: on(t) for n, t in kw.items()})
        torch.cuda.synchronize()
        for name, c in launch_counts().items():
            counts[name] = counts.get(name, 0) + c
        want = mha_grads(cpu, list(inputs), dout, **kw)
        worst = check_mha(f"mha-parity {label}", got, want)
        default = cls(e, heads, device=dev, impl="default", **opts)
        default.load_state_dict(gpu.state_dict())
        twin = mha_grads(default, [on(t) for t in inputs], on(dout),
                         **{n: on(t) for n, t in kw.items()})
        worst_twin = check_mha(f"mha-parity {label} fast vs default", got,
                               twin)
        log(f"  {label}: GPU == CPU within {worst:.3f} of the tolerances, "
            f"fast == default within {worst_twin:.3f}")
    log(f"  launches: {({n: c for n, c in counts.items() if c})}")
    for name in ("short_fwd_bias", "short_bwd_bias", "short_fwd_seg_drop_bias",
                 "short_bwd_seg_drop_bias", "short_fwd_drop_bias",
                 "short_fwd_seg_drop") + LN_TRAIN:
        if counts.get(name, 0) <= 0:
            fail(f"mha-parity: kernel {name} never launched")
    return counts


def attention_context(m, inputs, **kw) -> torch.Tensor:
    """The attention context ``(b, h, s, d)`` that module ``m`` hands its
    output projection in one forward without autograd: what the attention
    kernels computed, before the projection and the residual add."""
    seen = []
    project = m._project_out
    m._project_out = lambda ctx, query: (seen.append(ctx)
                                         or project(ctx, query))
    try:
        with torch.no_grad():
            m(*inputs, **kw)
    finally:
        del m._project_out
    return seen[0]


def phase_mha_train(dev) -> dict:
    """Contrib attention at Transformer-big's widths at O4 (fp32
    parameters, bf16 activations), ``bias=True``, ``include_norm_add=True``,
    attention dropout 0.1 with a key ``fold_in(base, step)`` a step, SBH
    batches of 32 x 256 target tokens (8192) with lengths drawn in
    128..256 as a ``key_padding_mask``: the encoder's self-attention, the
    decoder's with the future mask as a boolean ``attn_mask`` (the bias
    instances with ids and dropout), ``EncdecMultiheadAttn`` over 320
    source tokens (lengths in 160..320), and the decoder's again on a
    batch without padding and ``is_training=False`` (no dropout: the bias
    instances alone).  Each module: 3 warm-up and :data:`MHA_PASSES` timed
    forward+backward passes; ms each, tokens/s, peak memory, launches, one
    pass profiled by kernel (device ms, idle share); the output and the
    gradients must be finite, and the attention context of the last timed
    pass's key within two bf16 ulps of the same module's
    ``impl="default"`` one (same weights and key; the context, not the
    output, whose residual add would hide an attention error under the
    input's rounding)."""
    from apex_tpu_torch.amp import get_policy
    from apex_tpu_torch.contrib.multihead_attn import (
        EncdecMultiheadAttn, SelfMultiheadAttn)
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.random import PRNGKey, fold_in
    from torch.profiler import ProfilerActivity, profile

    e, heads, b, s, src = MHA_EMBED, MHA_HEADS, MHA_BATCH, MHA_SEQ, MHA_SRC
    log(f"[mha-train] embed {e}, {heads} heads of {e // heads}, O4, bias, "
        f"norm-add, dropout {MHA_DROPOUT}, b={b} x s={s} (source {src}), "
        f"padded: 3 warm-up + {MHA_PASSES} timed forward+backward passes a "
        "module")
    policy = get_policy("O4")
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(s, b, e, generator=gen, device=dev).to(torch.bfloat16)
    mem = torch.randn(src, b, e, generator=gen, device=dev).to(
        torch.bfloat16)
    dout = torch.randn(s, b, e, generator=gen, device=dev).to(torch.bfloat16)
    pad = torch.as_tensor(np.arange(s)[None] >= rng.integers(
        s // 2, s + 1, b)[:, None], device=dev)
    src_pad = torch.as_tensor(np.arange(src)[None] >= rng.integers(
        src // 2, src + 1, b)[:, None], device=dev)
    future = torch.ones(s, s, dtype=torch.bool, device=dev).triu(1)
    opts = dict(dropout=MHA_DROPOUT, bias=True, include_norm_add=True,
                policy=policy, device=dev)
    base = PRNGKey(5)
    counts = {}
    for label, cls, inputs, kw, need in (
            ("encoder self-attention", SelfMultiheadAttn, (x,),
             dict(key_padding_mask=pad),
             ("short_fwd_seg_drop", "short_bwd_seg_drop")),
            ("decoder self-attention, future mask", SelfMultiheadAttn, (x,),
             dict(key_padding_mask=pad, attn_mask=future),
             ("short_fwd_seg_drop_bias", "short_bwd_seg_drop_bias")),
            ("encoder-decoder attention", EncdecMultiheadAttn, (x, mem),
             dict(key_padding_mask=src_pad),
             ("short_fwd_seg_drop", "short_bwd_seg_drop")),
            ("decoder self-attention, future mask, no padding, "
             "is_training=False", SelfMultiheadAttn, (x,),
             dict(attn_mask=future, is_training=False),
             ("short_fwd_bias", "short_bwd_bias"))):
        m = cls(e, heads, key=PRNGKey(len(label)), **opts)
        xs = [t.detach().requires_grad_() for t in inputs]

        def step(i):
            m.zero_grad(set_to_none=True)
            out = m(*xs, rng=fold_in(base, i), **kw)
            out.backward(dout)
            return out

        for i in range(3):
            step(i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        for i in range(MHA_PASSES):
            out = step(3 + i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / MHA_PASSES
        c = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(3 + MHA_PASSES)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        grads = [p.grad for p in m.parameters()] + [t.grad for t in xs]
        if not torch.isfinite(out).all() or not all(
                torch.isfinite(g).all() for g in grads):
            fail(f"mha-train {label}: non-finite output or gradients")
        default = cls(e, heads, impl="default", **opts)
        default.load_state_dict(m.state_dict())
        key = fold_in(base, 2 + MHA_PASSES)     # the last timed pass's
        got = attention_context(m, inputs, rng=key, **kw)
        want = attention_context(default, inputs, rng=key, **kw)
        err, tol = max_err(got, want), tolerance(want)
        if not err <= tol:
            fail(f"mha-train {label}: attention context differs from "
                 f"impl='default' by {err:.3g} > {tol:.3g}")
        log(f"  {label}: {ms:.3f} ms per forward+backward, "
            f"{b * s / (ms / 1e3):,.0f} tokens/s, peak device memory "
            f"{peak:.2f} GiB, attention context within {err:.3g} of "
            f"impl='default' (two bf16 ulps: {tol:.3g}); launches in "
            f"{MHA_PASSES} passes {({n: v for n, v in c.items() if v})}")
        device_breakdown(prof, wall, "one pass profiled")
        log(f"  by kind: {attention_share(prof)}")
        for name in need + LN_TRAIN:
            if c.get(name, 0) <= 0:
                fail(f"mha-train {label}: kernel {name} never launched")
        for name, v in c.items():
            counts[name] = counts.get(name, 0) + v
        del m, default, xs, grads, out, got, want
    log("  *_bias launches: " + str({n: v for n, v in counts.items()
                                      if n.endswith("_bias")}))
    torch.cuda.empty_cache()
    return counts


def phase_mha_rungs(dev) -> dict:
    """``SelfMultiheadAttn`` on the ladder's other two rungs at
    Transformer-big's widths, fp32: ``attention_impl="mid"`` at b=8 x
    1024 with a per-head float ``attn_mask`` (8, 16, 1024, 1024), and
    ``attention_impl="pallas"`` at b=2 x 4096 with a per-batch one (2, 1,
    4096, 4096); forward and backward held against the same module's
    ``impl="default"`` (the plain attention) on the card with phase 6's
    tolerances.  The mid and flash bias instances' only path.  Returns
    the launches of the kernel runs."""
    from apex_tpu_torch.contrib.multihead_attn import SelfMultiheadAttn
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.random import PRNGKey

    e, heads = MHA_EMBED, MHA_HEADS
    log(f"[mha-rungs] embed {e}, {heads} heads, fp32: the mid rung at "
        f"8 x 1024 (per-head bias) and the flash rung at 2 x {LONG_SEQ} "
        "(per-batch bias) against impl='default' on the card")
    gen = torch.Generator(device=dev).manual_seed(2)
    counts = {}
    for rung, b, s, lead, need in (
            ("mid", 8, 1024, (8, heads), ("mid_fwd_bias", "mid_bwd_bias")),
            ("pallas", 2, LONG_SEQ, (2, 1),
             tuple(n + "_bias" for n in FLASH))):
        x = torch.randn(s, b, e, generator=gen, device=dev)
        dout = torch.randn(s, b, e, generator=gen, device=dev)
        mask = torch.randn(*lead, s, s, generator=gen, device=dev)
        m = SelfMultiheadAttn(e, heads, bias=True, attention_impl=rung,
                              device=dev, key=PRNGKey(9))
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        got = mha_grads(m, [x], dout, attn_mask=mask)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        c = launch_counts()
        default = SelfMultiheadAttn(e, heads, bias=True, impl="default",
                                    device=dev)
        default.load_state_dict(m.state_dict())
        want = mha_grads(default, [x], dout, attn_mask=mask)
        worst = check_mha(f"mha-rungs {rung}", got, want)
        log(f"  {rung} b={b} s={s} bias {tuple(mask.shape)}: kernels == "
            f"plain attention within {worst:.3f} of the tolerances; one "
            f"forward+backward {ms:.1f} ms (first call); launches "
            f"{({n: v for n, v in c.items() if v})}")
        for name in need:
            if c.get(name, 0) <= 0:
                fail(f"mha-rungs {rung}: kernel {name} never launched")
        for name, n in c.items():
            counts[name] = counts.get(name, 0) + n
        del m, default, got, want, mask
        torch.cuda.empty_cache()
    return counts


# ------------------------------------------------------- dbias-train
#: dbias-train's passes: (label, rung, b, heads, s, d, a (1, h, s, s) bias
#: (else a shared (s, s) one), mha-train's padding ids and dropout, the
#: dBias counter that must launch); every one causal
DBIAS_TRAIN = (
    ("Transformer-big's decoder", "short", MHA_BATCH, MHA_HEADS, MHA_SEQ, 64,
     True, False, "short_bwd_dbias"),
    ("Transformer-big's decoder, padding ids, dropout 0.1", "short",
     MHA_BATCH, MHA_HEADS, MHA_SEQ, 64, True, True,
     "short_bwd_seg_drop_dbias"),
    ("the flagship's attention, a shared (s, s) bias", "mid", 8,
     FLAGSHIP["num_attention_heads"], 1024, 128, False, False,
     "mid_bwd_dbias"),
    ("the Llama mode's attention", "flash", 2, LLAMA["num_attention_heads"],
     LONG_SEQ, 128, True, False, "flash_bwd_dq_dbias"),
)
DBIAS_STEPS = 5
RUNG_IMPL = {"short": "short", "mid": "mid", "flash": "pallas"}


def dbias_plain(rung, q, k, v, dout, bias, kw):
    """The bias's gradient of one forward+backward from the plain backward
    on the card (``dz``, folded into the bias's shape), fed with the
    kernel forward's ``out`` and ``lse``: what the step's backward took."""
    from apex_tpu_torch.ops import attention_flash as fl
    from apex_tpu_torch.ops import attention_mid as mid
    from apex_tpu_torch.ops import attention_short as short

    b, heads, s, d = q.shape
    ids = (kw.get("q_segment_ids"), kw.get("kv_segment_ids"))
    rate, seed = kw.get("dropout_rate", 0.0), kw.get("dropout_seed")
    drop = (rate, seed) if rate else None
    fwd_kw = dict(q_segment_ids=ids[0], kv_segment_ids=ids[1], bias=bias,
                  dropout_rate=rate, dropout_seed=seed)
    slab = short.bias_slab("bias", bias, b, heads, s, k.shape[2])
    if rung == "flash":
        flat = [t.reshape(b * heads, -1, d) for t in (q, k, v, dout)]
        out, lse = fl.flash_fwd(*flat[:3], True, heads=heads, **fwd_kw)
        dz = fl._flash_bwd_plain(*flat, lse, fl.flash_delta(out, flat[3]),
                                 True, d ** -0.5, *ids, heads, drop, slab,
                                 True)[3]
    else:
        fwd = short.short_fwd if rung == "short" else mid.mid_fwd
        out, lse = fwd(q, k, v, True, **fwd_kw)
        dz = short._short_bwd_plain(q, k, v, out, dout, lse, None, True,
                                    d ** -0.5, *ids, drop, slab, True)[3]
    return short.fold_bias_grad(dz.view(b, heads, s, -1), bias.shape,
                                bias.dtype)


def phase_dbias_train(dev) -> dict:
    """A trainable attention bias (dBias) at the widths of models the repo
    runs, O4 (fp32 parameters, bf16 q/k/v into the kernels, the bias
    fp32): q, k, v and an ``nn.Parameter`` bias, ``(1, h, s, s)`` or a
    shared ``(s, s)``, trained through ``flash_attention`` with the
    default ``bias_requires_grad=True`` for :data:`DBIAS_STEPS` steps of
    the port's ``FusedAdam`` against a fixed random target (the mean
    squared error of the output), at :data:`DBIAS_TRAIN`'s shapes: ms per
    forward+backward (the mean of steps 2 on, and their spread), peak
    device memory, the loss (finite and falling); the dBias instance of
    the pass must launch.  The first step's bias gradient is then held
    against the plain backward on the card, element by element
    (:func:`dbias_check`).  Last, at one small shape per rung (b=2 h=4
    s=300, fp32), a forward+backward on the GPU equals the CPU's: output,
    dq, dk and dv to 1e-4 of each tensor's largest, as phase 6 holds a
    step, and dBias by :func:`dbias_check`.  Returns the launches of the
    passes."""
    from apex_tpu_torch.ops import attention as att
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam

    log(f"[dbias-train] a trainable bias with q, k, v, O4, {DBIAS_STEPS} "
        "FusedAdam steps against a random target, causal")
    gen = torch.Generator(device=dev).manual_seed(7)
    counts = {}
    for label, rung, b, heads, s, d, per_head, padded, need in DBIAS_TRAIN:
        q, k, v, target = (torch.randn((b, heads, s, d), generator=gen,
                                       device=dev) for _ in range(4))
        lead = (1, heads) if per_head else ()
        params = [torch.nn.Parameter(t) for t in (q, k, v)] + [
            torch.nn.Parameter(0.5 * torch.randn(lead + (s, s), generator=gen,
                                                 device=dev))]
        kw = dict(causal=True, implementation=RUNG_IMPL[rung])
        if padded:
            pad = np.arange(s)[None] >= np.random.default_rng(0).integers(
                s // 2, s + 1, b)[:, None]
            kw.update(q_segment_ids=torch.zeros((b, s), dtype=torch.int32,
                                                device=dev),
                      kv_segment_ids=torch.as_tensor(
                          np.where(pad, -2, 0), dtype=torch.int32,
                          device=dev),
                      dropout_rate=MHA_DROPOUT)
        opt = FusedAdam(params, lr=1e-2)
        first = {}

        def step(i):
            opt.zero_grad(set_to_none=True)
            seed = dict(dropout_seed=1000 + i) if padded else {}
            x = [t.to(torch.bfloat16) for t in params[:3]]
            out = att.flash_attention(*x, bias=params[3], **kw, **seed)
            if i == 0:
                first.update(inputs=[t.detach() for t in x],
                             bias=params[3].detach().clone(), kw=dict(
                                 kw, **seed))
                out.register_hook(lambda g: first.update(dout=g.detach()))
            loss = (out.float() - target).square().mean()
            loss.backward()
            if i == 0:
                first["dbias"] = params[3].grad.detach().clone()
            return loss.detach()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        losses, spent = [], []
        for i in range(DBIAS_STEPS):
            t0 = time.perf_counter()
            losses.append(step(i))
            torch.cuda.synchronize()
            spent.append(time.perf_counter() - t0)
            opt.step()
        torch.cuda.synchronize()
        c = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = [x.item() for x in losses]
        ms = 1e3 * sum(spent[1:]) / (DBIAS_STEPS - 1)
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            fail(f"dbias-train {label}: loss not finite and falling: {losses}")
        if c.get(need, 0) <= 0:
            fail(f"dbias-train {label}: kernel {need} never launched")
        for name, n in c.items():
            counts[name] = counts.get(name, 0) + n
        qb, kb, vb = first["inputs"]
        fkw = {n: x for n, x in first["kw"].items()
               if n not in ("causal", "implementation")}
        want = dbias_plain(rung, qb, kb, vb, first["dout"], first["bias"],
                           fkw)
        err, share, median, top = dbias_check(
            f"dbias-train {label}: step 1", first["dbias"], want)
        log(f"  {label} ({rung}, b={b} h={heads} s={s} d={d}, bias "
            f"{tuple(params[3].shape)}): {ms:.3f} ms per forward+backward "
            f"(steps 2-{DBIAS_STEPS}: {1e3 * min(spent[1:]):.3f}-"
            f"{1e3 * max(spent[1:]):.3f}), peak device memory {peak:.2f} "
            f"GiB, loss {losses[0]:.5f} -> {losses[-1]:.5f}; step 1's dBias "
            f"within {err:.3g} of the plain backward, {share:.3g} of its "
            f"band ({DBIAS_TOL:g} of each row's largest |dbias|: "
            f"{median:.3g} the median row's, {top:.3g} the largest); "
            f"launches {({n: x for n, x in c.items() if x})}")
        del params, opt, first, q, k, v, target, want
        torch.cuda.empty_cache()
    dbias_cpu_parity(dev)
    return counts


def dbias_cpu_parity(dev) -> None:
    """One forward+backward with a trainable bias on the GPU (the dBias
    instances) and on the CPU (the plain versions), fp32, b=2 h=4 s=300
    d=64, causal, each rung forced: the short one with padding ids and
    dropout and a (1, h, s, s) bias, mid with a shared (s, s) one, flash
    with a per-batch (b, 1, s, s) one.  Output, dq, dk and dv to 1e-4 of
    each tensor's largest, as phase 6 holds a training step; dBias
    element by element (:func:`dbias_check`)."""
    from apex_tpu_torch.ops import attention as att

    b, heads, s, d = 2, 4, 300, 64
    rng = np.random.default_rng(11)
    pad = np.arange(s)[None] >= np.array([[s], [2 * s // 3]])
    for rung, lead, padded in (("short", (1, heads), True), ("mid", (), False),
                               ("flash", (b, 1), False)):
        arrays = [rng.standard_normal((b, heads, s, d), np.float32)
                  for _ in range(4)] + [
            rng.standard_normal(lead + (s, s), np.float32)]
        kw = dict(causal=True, implementation=RUNG_IMPL[rung])
        if padded:
            kw.update(q_segment_ids=np.zeros((b, s), np.int32),
                      kv_segment_ids=np.where(pad, -2, 0).astype(np.int32),
                      dropout_rate=0.1, dropout_seed=77)
        results = []
        for device in (dev, torch.device("cpu")):
            q, k, v, dout, bias = (torch.tensor(x, device=device,
                                                requires_grad=i != 3)
                                   for i, x in enumerate(arrays))
            on = {n: torch.as_tensor(x, device=device)
                  if isinstance(x, np.ndarray) else x for n, x in kw.items()}
            out = att.flash_attention(q, k, v, bias=bias, **on)
            out.backward(dout)
            results.append([t.detach().cpu() for t in (
                out, q.grad, k.grad, v.grad, bias.grad)])
        worst = 0.0
        for name, g, c in zip(("out", "dq", "dk", "dv"), *results):
            tol = 1e-4 * c.abs().max().item() + 1e-9
            err = max_err(g, c)
            worst = max(worst, err / tol)
            if not err <= tol:
                fail(f"dbias-train {rung} GPU vs CPU: {name} differs by "
                     f"{err:.3g} > {tol:.3g}")
        _, share, _, _ = dbias_check(f"dbias-train {rung} GPU vs CPU",
                                     *(r[-1] for r in results))
        log(f"  {rung} b={b} h={heads} s={s}, bias {lead + (s, s)}"
            + (", ids, dropout" if padded else "")
            + f", fp32: GPU == CPU (out, dq, dk, dv) within {worst:.3f} of "
            f"the tolerances, dbias within {share:.3f} of its band")


# ------------------------------------------------------------ BERT phases
#: BERT-large as bench.py:516-518 shapes it and Google's bert_config.json
#: for BERT-Large publishes it: vocab 30522, 24 layers, hidden 1024, 16
#: heads of 64, ffn 4096, 512 positions, 2 token types
BERT_LARGE = dict(vocab_size=30522, num_layers=24, hidden_size=1024,
                  num_attention_heads=16, ffn_hidden_size=4096,
                  max_position_embeddings=512, num_tokentypes=2)
BERT_BATCH, BERT_SEQ = 16, 512


def bert_batch(rng, b: int, s: int, vocab: int, lo: int = 128) -> tuple:
    """A BERT pretraining batch: lengths drawn in ``lo..s`` (padding past
    them), token types 1 on the second half of each sequence, 15% of the
    real positions masked-LM targets, binary labels.  ``(tokens, lm
    labels, loss mask, attention mask, binary labels, token types)`` as
    numpy arrays, the order ``BertModel.loss`` takes them."""
    lengths = rng.integers(lo, s + 1, b)
    pos = np.arange(s)[None]
    mask = pos < lengths[:, None]
    tokens = (rng.integers(0, vocab, (b, s)) * mask).astype(np.int32)
    types = (mask & (pos >= lengths[:, None] // 2)).astype(np.int32)
    loss_mask = ((rng.random((b, s)) < 0.15) & mask).astype(np.float32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    binary = rng.integers(0, 2, b).astype(np.int32)
    return tokens, labels, loss_mask, mask, binary, types


def phase_bert_parity(dev) -> dict:
    """BERT at BERT-large's widths, 2 layers, fp32 (O0), b=2 x 512 with
    ragged lengths: one step (loss, backward, FusedAdam) on the GPU
    through the kernels against a CPU copy through the plain versions;
    then ``attention_impl`` short, mid and pallas on the card agree on
    the loss and every gradient; then ``contrib.fmha`` at BERT-large's
    head widths (8 packed sequences, max_s 512) equals its plain path on
    the CPU, forward and backward.  Returns the GPU step's launches."""
    from apex_tpu_torch.amp import get_policy
    from apex_tpu_torch.contrib.fmha import fmha
    from apex_tpu_torch.models import BertConfig, BertModel
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam

    lr = 1e-3
    log("[bert-parity] BERT-large widths, 2 layers, fp32 (O0), b=2 x 512 "
        f"ragged: one step on the GPU vs the CPU, FusedAdam lr={lr}")
    cfg = BertConfig(**dict(BERT_LARGE, num_layers=2),
                     policy=get_policy("O0"))
    # b=2 (4 before the fp16 phases came, cut for the script's wall: the
    # CPU's step)
    data = bert_batch(np.random.default_rng(1), 2, BERT_SEQ,
                      cfg.vocab_size)
    gpu = BertModel(cfg, device=dev, seed=5)
    cpu = BertModel(cfg, device="cpu", seed=5)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    before = {k: v.cpu().clone() for k, v in gpu.state_dict().items()}
    out = []
    for model in (gpu, cpu):
        batch = [torch.as_tensor(a, device=model.device) for a in data]
        opt = FusedAdam(model.parameters(), lr=lr)
        if model is gpu:
            torch.cuda.synchronize()
            reset_launch_counts()
        out.append(step_of(model, opt, batch))
        if model is gpu:
            torch.cuda.synchronize()
            counts = launch_counts()
    worst_g, worst_p, n_sure = check_step("bert-parity", *out, before, lr)
    log(f"  loss {out[0][0]:.6f} (GPU) vs {out[1][0]:.6f} (CPU); every grad "
        f"within 1e-4 of its scale (worst {worst_g:.3f} of the tolerance); "
        f"updated params within 1% of a step at {n_sure} sure-sign elements "
        f"(worst {worst_p:.3f} of it); launches {counts}")
    for name in ("short_fwd_seg", "short_bwd_seg") + LN_TRAIN:
        if counts.get(name, 0) <= 0:
            fail(f"bert-parity: kernel {name} never launched")
    del cpu, out
    # the three rungs on the card, from the same weights
    state = {k: v.clone() for k, v in before.items()}
    batch = [torch.as_tensor(a, device=dev) for a in data]
    rungs = {}
    for impl in ("short", "mid", "pallas"):
        model = BertModel(dataclasses.replace(cfg, attention_impl=impl),
                          device=dev)
        model.load_state_dict(state)
        loss = model.loss(*batch)
        loss.backward()
        rungs[impl] = (loss.item(), {n: p.grad.cpu() for n, p in
                                     model.named_parameters()})
        del model
    (ls, gs) = rungs["short"]
    for impl in ("mid", "pallas"):
        li, gi = rungs[impl]
        if not abs(li - ls) <= 1e-5 * max(1.0, abs(ls)):
            fail(f"bert-parity: loss {li} ({impl}) vs {ls} (short)")
        for n, g in gs.items():
            tol = 1e-4 * g.abs().max().item() + 1e-9
            if (gi[n] - g).abs().max().item() > tol:
                fail(f"bert-parity: {impl} grad {n} differs from the short "
                     f"rung's by more than {tol:.3g}")
    log(f"  attention_impl short/mid/pallas on the GPU: losses "
        f"{ls:.6f}/{rungs['mid'][0]:.6f}/{rungs['pallas'][0]:.6f}, every "
        "grad within 1e-4 of its scale of the short rung's")
    del gpu, rungs
    torch.cuda.empty_cache()
    # fmha on the card against its plain path on the CPU
    heads, d = BERT_LARGE["num_attention_heads"], 64
    lens = np.random.default_rng(2).integers(64, BERT_SEQ + 1, 8)
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    gen = torch.Generator().manual_seed(3)
    qkv = torch.randn((int(cu[-1]), 3, heads, d), generator=gen)
    dout = torch.randn((int(cu[-1]), heads, d), generator=gen)
    res = []
    for device in (dev, torch.device("cpu")):
        x = qkv.to(device).requires_grad_()
        o = fmha(x, torch.as_tensor(cu), BERT_SEQ)
        o.backward(dout.to(device))
        res.append((o.detach().cpu(), x.grad.cpu()))
    for what, got, want in (("out", res[0][0], res[1][0]),
                            ("dqkv", res[0][1], res[1][1])):
        err = max_err(got, want)
        tol = 1e-4 * max(1.0, want.abs().max().item())
        if not err <= tol:
            fail(f"bert-parity: fmha {what} on the GPU differs from the CPU "
                 f"by {err:.3g} > {tol:.3g}")
        log(f"  fmha (8 sequences of {lens.min()}..{lens.max()} tokens, "
            f"max_s {BERT_SEQ}, h={heads} d={d}) {what}: GPU vs CPU "
            f"max_abs_err {err:.3g} (tolerance {tol:.3g})")
    return counts


def is_tail_kernel(key: str) -> bool:
    """A kernel of ``csrc/multi_tensor.cu`` (the optimizer tail) by its
    profiler name."""
    return any(f"::{w}<" in key or f"::{w}(" in key
               for w in ("step_kernel", "scale_kernel", "l2norm_kernel",
                         "l2norm_total_kernel", "fold_kernel"))


def attention_share(prof) -> str:
    """The device time of one profiled run by kind of kernel: the
    attention kernels (``attn_``/``flash_`` entries of the CUDA sources
    and the Hopper kernels of the ``attn::sm90`` namespace, whose names
    carry neither), layer norm (``ln_fwd``, ``ln_bwd``, ``ln_bwd_fold``),
    matrix products (cuBLAS's
    ``nvjet``/``sm90`` and CUTLASS kernels) and the rest (elementwise,
    copies, reductions)."""
    kinds = {"attention": 0.0, "layer norm": 0.0, "matmul": 0.0,
             "optimizer tail": 0.0, "other": 0.0}
    for t, _, key in device_rows(prof):
        k = key.lower()
        if is_tail_kernel(key):
            kinds["optimizer tail"] += t
        elif "attn_" in k or "attn::" in k or "flash_" in k:
            kinds["attention"] += t
        elif "ln_fwd" in k or "ln_bwd" in k or "layer_norm" in k:
            kinds["layer norm"] += t
        elif any(w in k for w in ("gemm", "xmma", "cutlass", "matmul",
                                  "nvjet", "sm90_")):
            kinds["matmul"] += t
        else:
            kinds["other"] += t
    busy = sum(kinds.values())
    if not busy:
        return "not measured (the profiler saw no device time)"
    return ", ".join(f"{name} {t / 1e3:.2f} ms ({100 * t / busy:.1f}%)"
                     for name, t in kinds.items())


def phase_bert_train(dev, fused_ce=None, label="bert-train",
                     profile=True) -> dict:
    """BERT-large (24 layers) at O4 (bf16 compute, fp32 parameters and
    Adam state), remat on, b=16 x 512 with lengths drawn in 128..512, 15%
    MLM positions and binary labels: 2 warm-up and 10 timed steps of loss
    -> backward -> FusedAdam (lr 1e-4) on one batch; the loss must be
    finite and fall, and the short rung's segment kernels must launch.
    ``fused_ce`` goes to ``BertConfig`` (None: by logits size, here the
    two-step path; True the fused chunked one, chunks of 5087).  Prints
    ms/step, real and padded tokens/s, MFU, peak memory and the launches;
    then (``profile``) one step profiled, broken down by kernel."""
    from apex_tpu_torch.amp import get_policy
    from apex_tpu_torch.models import BertConfig, BertModel
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.telemetry import mfu, transformer_flops_per_token

    b, s = BERT_BATCH, BERT_SEQ
    log(f"[{label}] BERT-large, 24 layers, O4, remat on, b={b} x {s} "
        f"(lengths 128..512, 15% MLM), fused_ce={fused_ce}, FusedAdam lr "
        "1e-4: 2 warm-up + 10 timed steps on one batch")
    policy = get_policy("O4")
    model = BertModel(BertConfig(**BERT_LARGE, policy=policy,
                                 fused_ce=fused_ce), device=dev, seed=0)
    opt = FusedAdam(model.parameters(), lr=1e-4,
                    master_weights=policy.master_weights)
    data = bert_batch(np.random.default_rng(0), b, s,
                      BERT_LARGE["vocab_size"])
    batch = [torch.as_tensor(a, device=dev) for a in data]
    n_params = sum(p.numel() for p in model.parameters())
    real = int(data[3].sum())

    def step():
        opt.zero_grad(set_to_none=True)
        loss = model.loss(*batch)
        loss.backward()
        opt.step()
        return loss.detach()

    warm = [step() for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    losses = [step() for _ in range(10)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    losses = [float(x) for x in torch.stack(warm + losses).cpu()]
    # Adam without warm-up lifts a fresh BERT-large's loss for a step or
    # two (every weight moves by about lr at once) before it falls: held
    # to end below where it started and below its middle
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < min(losses[0], losses[len(losses) // 2]):
        fail(f"{label}: losses {losses} are not finite and falling")
    ms = 1e3 * wall / 10
    padded_tps, real_tps = b * s / (ms / 1e3), real / (ms / 1e3)
    fpt = transformer_flops_per_token(n_params, BERT_LARGE["num_layers"],
                                      BERT_LARGE["hidden_size"], s)
    peak = PEAK_OPS_PER_S[torch.bfloat16]
    log(f"  losses: {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"  {ms:.2f} ms/step, {padded_tps:,.0f} padded tokens/s, "
        f"{real_tps:,.0f} real tokens/s ({real} of {b * s} tokens real), "
        f"MFU {mfu(padded_tps, fpt, peak):.4f} on padded tokens "
        f"({mfu(real_tps, fpt, peak):.4f} on real ones) against the 989 "
        f"TFLOP/s bf16 dense peak ({n_params:,} params; {fpt:,} model FLOPs "
        f"per token, 6·N + 12·L·h·s at s={s})")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        " GiB")
    log(f"  launches in the 10 timed steps: {counts} (per step: "
        + ", ".join(f"{k} {v / 10:g}" for k, v in sorted(counts.items()))
        + ")")
    for name in LN_TRAIN + ("short_fwd_seg", "short_bwd_seg"):
        if counts.get(name, 0) <= 0:
            fail(f"{label}: kernel {name} never launched on the main path")
    if profile:
        phase_profile_train(types.SimpleNamespace(step=step), (),
                            f"BERT-large (O4, {b} x {s})")
    del model, opt, batch
    torch.cuda.empty_cache()
    return counts


def phase_bert_finetune(dev) -> dict:
    """``examples/bert_finetune.main`` at its default model size (2
    layers, hidden 64, 4 heads, vocab 128, 32 tokens; head dim 16, padded
    to 64 for the kernels) and O4, 200 steps at batch 16 on the GPU: the
    held-out accuracy must rise from chance to 0.8 or more (at the JAX
    example's batch of 4 neither package's run rises in 200 steps)."""
    from apex_tpu_torch.examples import bert_finetune
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts

    flags = ["--steps", "200", "--batch", "16", "--log-every", "50",
             "--device", str(dev)]
    log(f"[bert-finetune] bert_finetune {' '.join(flags)}")
    torch.cuda.synchronize()
    reset_launch_counts()
    out = bert_finetune.main(flags)
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"  held-out accuracy {out['initial_eval_accuracy']:.3f} -> "
        f"{out['eval_accuracy']:.3f}; {out['ms_per_step']:.2f} ms/step; "
        f"launches {counts}")
    if not out["eval_accuracy"] >= 0.8 or \
            not out["eval_accuracy"] > out["initial_eval_accuracy"]:
        fail("bert-finetune: the held-out accuracy did not rise from chance")
    for name in LN_TRAIN + ("short_fwd_seg", "short_bwd_seg"):
        if counts.get(name, 0) <= 0:
            fail(f"bert-finetune: kernel {name} never launched")
    return counts


FMHA_MAX_S = (512, 1024, 4096)


def phase_fmha_varlen(dev) -> dict:
    """``FMHA()(qkv, cu_seqlens, max_s)`` at BERT-large's head widths (16
    heads of 64), 8 packed sequences of 64..512 tokens, forward and
    backward in bf16 at max_s 512, 1024 and 4096: the short, mid and flash
    rungs' segment instances, all of which must launch.  Then, in fp32,
    each max_s's output and gradient against the plain attention of each
    sequence alone (``mha_reference`` through autograd, on the card)."""
    from apex_tpu_torch.contrib.fmha import FMHA
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.ops.attention import mha_reference

    heads, d = BERT_LARGE["num_attention_heads"], 64
    lens = np.random.default_rng(4).integers(64, 513, 8)
    cu = torch.as_tensor(np.concatenate([[0], np.cumsum(lens)]),
                         dtype=torch.int32, device=dev)
    total = int(cu[-1])
    gen = torch.Generator(device=dev).manual_seed(4)
    qkv32 = torch.randn((total, 3, heads, d), generator=gen, device=dev)
    dout32 = torch.randn((total, heads, d), generator=gen, device=dev)
    fm = FMHA()
    log(f"[fmha-varlen] FMHA at h={heads} d={d}, 8 sequences of "
        f"{lens.min()}..{lens.max()} tokens ({total} in all), bf16 forward "
        f"and backward at max_s {FMHA_MAX_S}")
    qkv = qkv32.to(torch.bfloat16).requires_grad_()
    dout = dout32.to(torch.bfloat16)
    torch.cuda.synchronize()
    reset_launch_counts()
    times = []
    for max_s in FMHA_MAX_S:
        t0 = time.perf_counter()
        fm(qkv, cu, max_s).backward(dout)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    counts = launch_counts()
    log(f"  launches {counts}; wall ms per forward+backward (first call): "
        + ", ".join(f"max_s {m} {t:.2f}" for m, t in zip(FMHA_MAX_S, times)))
    for name in ("short_fwd_seg", "short_bwd_seg", "mid_fwd_seg",
                 "mid_bwd_seg", "flash_fwd_seg", "flash_bwd_dkv_seg",
                 "flash_bwd_dq_seg"):
        if counts.get(name, 0) <= 0:
            fail(f"fmha-varlen: kernel {name} never launched")
    for max_s in FMHA_MAX_S:
        x = qkv32.detach().requires_grad_()
        # eager: fmha reads cu_seqlens on the host, so no graph capture
        ms = _events_ms(lambda: [fm(qkv.detach(), cu, max_s)
                                 for _ in range(10)], 10)
        out = fm(x, cu, max_s)
        out.backward(dout32)
        ref = qkv32.detach().requires_grad_()
        want = torch.cat([
            mha_reference(*(ref[a:e, i].transpose(0, 1)[None]
                            for i in range(3)))[0].transpose(0, 1)
            for a, e in zip(cu[:-1].tolist(), cu[1:].tolist())])
        want.backward(dout32)
        err = max(check("fmha", out, want, f"fp32 max_s={max_s} out"),
                  check("fmha", x.grad, ref.grad, f"fp32 max_s={max_s} dqkv"))
        log(f"  max_s {max_s}: bf16 forward {ms:.4f} ms per eager call; fp32 "
            f"against each sequence alone, max_abs_err {err:.3g}")
    return counts


# ------------------------------------------------ optimizer tail kernels
#: the optimizer's coefficients in phase 2's checks (the trainer's lr and
#: JAX FusedAdam's defaults, AdamW with decay; LAMB's defaults)
OPT_HYPER = dict(lr=3e-4, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=0.01, adam_w_mode=True)
LAMB_HYPER = dict(lr=1e-3, beta1=0.9, beta2=0.999, beta3=0.1, eps=1e-6,
                  weight_decay=0.01, adam_w_mode=True, use_trust=True)
#: the norms' band: fp32 sums of squares in two orders (the kernel's
#: chunks of 65,536, torch.sum's tree), relative to the norm
NORM_REL_TOL = 1e-5
#: a clip factor or a trust ratio from such a norm moves a step's update
#: by a few 1e-7 of itself: each value within MASTER_ULPS ulps of its
#: dtype plus STEP_REL of the step it took
MASTER_ULPS = 2
STEP_REL = 1e-5


def flagship_list(dev, level: str = "O5"):
    """The flagship's parameter tensors at ``level`` (O5: bf16 weights,
    fp32 norm parameters; O2: fp16 weights, fp32 norm parameters):
    ``(shapes, dtypes)`` in ``model.parameters()`` order."""
    from apex_tpu_torch.amp import get_policy
    from apex_tpu_torch.models import GPTConfig, GPTModel

    model = GPTModel(GPTConfig(**FLAGSHIP, policy=get_policy(level)),
                     device=dev, seed=0)
    out = [(tuple(p.shape), p.dtype) for p in model.parameters()]
    del model
    torch.cuda.empty_cache()
    return out


def make(randn, shape, dtype, skew=False, scale=1.0):
    """A random tensor; with ``skew`` a view one element into a larger one,
    off the 16-byte grid."""
    if not skew:
        return randn(*shape, dtype=dtype, scale=scale)
    n = math.prod(shape)
    return randn(n + 1, dtype=dtype, scale=scale)[1:].view(shape)


def opt_state(randn, specs, master=True, v_dtype=torch.float32):
    """Random parameters, gradients and Adam state for ``specs``
    (``(shape, dtype[, skew])``), as a step at the middle of training has
    them: ``(params, grads, masters, exp_avgs, exp_avg_sqs)``."""
    sk = lambda sp: len(sp) > 2 and sp[2]
    params = [make(randn, sp[0], sp[1], sk(sp), 0.02) for sp in specs]
    grads = [make(randn, sp[0], sp[1], sk(sp), 1e-3) for sp in specs]
    masters = ([make(randn, sp[0], torch.float32, sk(sp)).copy_(p)
                for sp, p in zip(specs, params)] if master else None)
    ms = [make(randn, sp[0], torch.float32, sk(sp), 1e-4) for sp in specs]
    vs = [make(randn, sp[0], v_dtype, sk(sp)).copy_(
        randn(*sp[0], scale=1e-4) ** 2) for sp in specs]
    return params, grads, masters, ms, vs


def clone_state(state):
    return tuple(None if ts is None else [t.clone() for t in ts]
                 for ts in state)


def state_equal(a, b) -> bool:
    return all(x is y or all(torch.equal(s, t) for s, t in zip(x, y))
               for x, y in zip(a, b))


def ulp_of(x: torch.Tensor) -> torch.Tensor:
    """The spacing of ``x``'s dtype (fp32, bf16 or fp16) at ``x``'s
    magnitude, in fp32."""
    bits, tiny = {torch.float32: (23, 2.0 ** -126),
                  torch.float16: (10, 2.0 ** -14)}.get(x.dtype,
                                                       (7, 2.0 ** -126))
    return torch.exp2(torch.floor(torch.log2(
        x.float().abs().clamp_min(tiny))) - bits)


def band_off(got, want, before) -> float:
    """The largest distance of ``got`` from ``want`` as a share of the
    band MASTER_ULPS ulps of ``want`` plus STEP_REL of the step
    ``want - before``."""
    w = want.float()
    band = (MASTER_ULPS * ulp_of(want)
            + STEP_REL * (w - before.float()).abs())
    return ((got.float() - w).abs() / band).max().item()


def step_bytes(specs, master=True, v_bytes=4) -> int:
    """The bytes an Adam or LAMB step over ``specs`` must move: each
    gradient and (without masters) parameter read, each master and moment
    read and written, each parameter written."""
    total = 0
    for s, d in specs:
        n = math.prod(s)
        item = torch.empty((), dtype=d).element_size()
        # the gradient read, the parameter written, the moments read and
        # written, the master read and written (or the parameter read)
        total += n * (2 * item + 8 + 2 * v_bytes + (8 if master else item))
    return total


def run_step(kernel, state, *, plain=False, **kw):
    """One Adam (``kernel="adam"``) or LAMB step over ``state`` in place,
    through the kernel or its plain version on the card."""
    from apex_tpu_torch.ops import multi_tensor as mt

    params, grads, masters, ms, vs = state
    rows = mt.step_rows(params, masters, ms, vs)
    hyper = dict(OPT_HYPER if kernel == "adam" else LAMB_HYPER)
    if not plain:
        getattr(mt, kernel)(grads, rows, **hyper, **kw)
        return
    h = mt._hyper(hyper["beta1"], hyper["beta2"],
                  hyper.get("beta3", f32_sub(1.0, hyper["beta1"])),
                  hyper["eps"], hyper["lr"], hyper["weight_decay"],
                  hyper["adam_w_mode"])
    args = (grads, rows, kw.get("inv_scale"), kw.get("clip"),
            kw.get("finite"), kw.get("bc1"), kw.get("bc2"), h)
    if kernel == "adam":
        mt._adam_plain(*args)
    else:
        mt._lamb_plain(*args, hyper["use_trust"])


def f32_sub(a: float, b: float) -> float:
    return float(np.float32(a) - np.float32(b))


def check_opt_step(label, kernel, got, want, exact: bool,
                   before) -> float:
    """A step's results through the kernel against the plain version's:
    equal bits, or (a clip factor or trust ratios from sums in another
    order) each value within MASTER_ULPS ulps plus STEP_REL of its step
    (``before`` is the state the step started from).  Returns the largest
    |difference|."""
    worst = 0.0
    for what, a, b, o in zip(("param", "grad", "master", "exp_avg",
                              "exp_avg_sq"), got, want, before):
        if a is None:
            continue
        for i, (x, y, z) in enumerate(zip(a, b, o)):
            if x.numel() == 0:
                continue
            worst = max(worst, max_err(x, y))
            if exact:
                if not torch.equal(x, y):
                    fail(f"{label}: {kernel} {what} {i} differs from the "
                         f"plain version (max |diff| {max_err(x, y):.3g})")
            else:
                off = band_off(x, y, z)
                if not off <= 1.0:
                    fail(f"{label}: {kernel} {what} {i} {off:.2f} of its "
                         f"band off the plain version ({MASTER_ULPS} ulps "
                         f"+ {STEP_REL} of the step)")
    return worst


def edge_lists():
    """Lists the flagship's does not reach: a zero-size tensor, odd
    lengths (1, 7, 1001, one chunk + 1, two chunks + 3), bf16 and fp32
    tensors beside each other and one off the 16-byte grid (the
    one-by-one path); 600 tensors of 5 elements (more tensors than one
    launch's table holds); one bf16 tensor of 4,100 chunks + 5 elements
    (more blocks than a table holds: the tensor splits over two)."""
    return {
        "odd lengths and dtypes": [
            ((0,), torch.bfloat16), ((1,), torch.float32),
            ((7,), torch.bfloat16), ((1001,), torch.float32),
            ((65537,), torch.bfloat16), ((2 * 65536 + 3,), torch.float32),
            ((33, 31), torch.bfloat16, True), ((40,), torch.float32, True)],
        "600 tensors": [((5,), torch.float32)] * 600,
        "4,101 chunks": [((4100 * 65536 + 5,), torch.bfloat16)],
    }


def optimizer_kernels(randn, dev) -> dict:
    """The four multi-tensor kernels of the optimizer tail
    (``csrc/multi_tensor.cu``) against their plain versions on the card:
    at the flagship's 148 tensors at O5 (bf16 weights, fp32 norm
    parameters, fp32 masters) and on edge lists; ``multi_tensor_adam``
    equal to the plain version bit for bit without a clip, with the loss
    scaler's unscale folded in, and with a bf16 second moment; within
    MASTER_ULPS with a clip; an inf at the list's first and last element
    skips the whole step bit for bit; then each kernel timed beside its
    plain version, its bound and the PyTorch call that computes the same
    function."""
    from apex_tpu_torch.ops import multi_tensor as mt

    specs = flagship_list(dev)
    n_el = sum(math.prod(s) for s, _ in specs)
    log(f"[kernels] optimizer tail (CUDA multi-tensor), the flagship's "
        f"{len(specs)} tensors at O5 ({n_el:,} elements: "
        f"{sum(d == torch.bfloat16 for _, d in specs)} bf16, "
        f"{sum(d == torch.float32 for _, d in specs)} fp32)")
    one = lambda v: torch.full((), v, dtype=torch.float32, device=dev)
    bc = dict(bc1=one(f32_sub(1.0, 0.9 ** 7)),
              bc2=one(f32_sub(1.0, 0.999 ** 7)))
    records = {}
    # O2's list: fp16 weights (with fp32 masters, and in the "no masters"
    # case O3's fp16 parameters updated in place)
    specs_o2 = flagship_list(dev, "O2")
    lists = {"flagship": specs, "flagship O2": specs_o2, **edge_lists()}
    errs = {}
    for label, sp in lists.items():
        # -- scale (in place, out of place, axpby) and the check ----------
        xs = [make(randn, *x) for x in sp]
        outs = [torch.empty_like(x) for x in xs]
        want = [torch.empty_like(x) for x in xs]
        fk = mt.scale(xs, one(0.37), out=outs)
        fp = torch.ones((), dtype=torch.bool, device=dev)
        mt._scale_plain(xs, one(0.37), None, 0.0, want, fp)
        ys = [make(randn, *x) for x in sp]
        ax, axw = ([torch.empty_like(x) for x in xs] for _ in range(2))
        mt.scale(xs, 0.5, ys=ys, b=-1.25, out=ax)
        mt._scale_plain(xs, 0.5, ys, -1.25, axw,
                        torch.ones((), dtype=torch.bool, device=dev))
        if not (all(torch.equal(a, b) for a, b in zip(outs, want))
                and all(torch.equal(a, b) for a, b in zip(ax, axw))
                and bool(fk) and bool(fp)):
            fail(f"optimizer {label}: multi_tensor_scale (or its axpby "
                 "instance) differs from the plain version")
        nz = [i for i, x in enumerate(xs) if x.numel()]
        for i, pos in ((nz[0], 0), (nz[-1], -1)):
            xs[i].view(-1)[pos] = float("inf")
            if bool(mt.scale(xs)):
                fail(f"optimizer {label}: an inf at tensor {i} escaped the "
                     "finite check")
            xs[i].view(-1)[pos] = 0.0
        # -- l2norm ------------------------------------------------------
        gs = [make(randn, *x, scale=1e-3) for x in sp]
        del xs, ys, outs, want, ax, axw
        inv = one(2.0 ** -3)
        for inv_scale in (None, inv):
            nk = mt.l2norm(gs, inv_scale=inv_scale, per_tensor=True)
            npl = mt._l2norm_plain(gs, inv_scale, True, torch.ones(
                (), dtype=torch.bool, device=dev))
            rel = ((nk.per_tensor - npl.per_tensor).abs()
                   / npl.per_tensor.clamp_min(1e-30)).max().item()
            rel = max(rel, abs(nk.total.item() - npl.total.item())
                      / npl.total.item())
            again = mt.l2norm(gs, inv_scale=inv_scale, per_tensor=True)
            if not (rel <= NORM_REL_TOL and bool(nk.finite)
                    and torch.equal(again.per_tensor, nk.per_tensor)
                    and torch.equal(again.total, nk.total)):
                fail(f"optimizer {label}: multi_tensor_l2norm {rel:.3g} "
                     f"off the plain norms (band {NORM_REL_TOL}) or not "
                     "the same bits twice")
        log(f"  {label}: scale, axpby equal to the plain version; l2norm "
            f"within {rel:.2g} (band {NORM_REL_TOL}), same bits twice")
        # -- adam and lamb -----------------------------------------------
        cases = (("adam", "no clip", True, {}, torch.float32),
                 ("adam", "unscale folded", True, dict(inv_scale=inv),
                  torch.float32),
                 ("adam", "bf16 exp_avg_sq", True, {}, torch.bfloat16),
                 ("adam", "no masters", False, {}, torch.float32),
                 ("adam", "clip", True, dict(clip=one(0.3)), torch.float32),
                 ("lamb", "trust ratios", True, {}, torch.float32))
        for kernel, what, master, kw, v_dtype in cases:
            if label == "flagship O2" and what not in ("no clip",
                                                       "no masters"):
                continue    # O2's and O3's steps; the rest as at O5
            state = opt_state(randn, sp, master, v_dtype)
            ref = clone_state(state)
            orig = clone_state(state)
            if kernel == "adam" and "clip" in kw:
                # the clip factor from each side's own norm
                gk = mt.l2norm(state[1]).total
                gp = mt._l2norm_plain(ref[1], None, False, torch.ones(
                    (), dtype=torch.bool, device=dev)).total
                kw = dict(clip=torch.where(gk > 1e-3, one(1e-3) / gk,
                                           one(1.0)))
                kw_plain = dict(clip=torch.where(gp > 1e-3, one(1e-3) / gp,
                                                 one(1.0)))
            else:
                kw_plain = kw
            run_step(kernel, state, **bc, **kw)
            run_step(kernel, ref, plain=True, **bc, **kw_plain)
            exact = kernel == "adam" and what != "clip"
            err = check_opt_step(f"optimizer {label} {what}", kernel, state,
                                 ref, exact, orig)
            errs[(label, kernel, what)] = err
            del state, ref, orig
            log(f"  {label}: multi_tensor_{kernel} {what}: "
                + ("equal bits" if exact else
                   f"within the band (max |diff| {err:.3g})"))
        # -- a non-finite gradient skips everything ----------------------
        for kernel in ("adam", "lamb"):
            state = opt_state(randn, sp, True)
            grads = state[1]
            for i, pos in ((nz[0], 0), (nz[-1], -1)):
                before = clone_state(state)
                grads[i].view(-1)[pos] = float("inf")
                finite = mt.scale(grads)
                run_step(kernel, state, finite=finite, **bc)
                grads[i].view(-1)[pos] = before[1][i].view(-1)[pos]
                if bool(finite) or not state_equal(state, before):
                    fail(f"optimizer {label}: multi_tensor_{kernel} wrote "
                         f"with an inf at tensor {i}")
            del state, before
        log(f"  {label}: an inf at the first or the last element skips "
            "adam and lamb, every bit kept")
    torch.cuda.synchronize()
    # -- timing at the flagship's list -----------------------------------
    state = opt_state(randn, specs, True)
    params, grads, masters, ms, vs = state
    g_bytes = sum(g.numel() * g.element_size() for g in grads)
    shape = f"{len(specs)} tensors, {n_el:,} elements, O5"
    rows = mt.step_rows(params, masters, ms, vs)
    plain_state = clone_state(state)
    prow = mt.step_rows(plain_state[0], plain_state[2], plain_state[3],
                        plain_state[4])
    h = mt._hyper(0.9, 0.999, f32_sub(1.0, 0.9), 1e-8, 3e-4, 0.01, True)
    # the library's fused AdamW over fp32 copies, without masters
    lib_p = [m.clone() for m in masters]
    lib_g = [g.float() for g in grads]
    lib_m, lib_v = [m.clone() for m in ms], [v.clone() for v in vs]
    lib_steps = [torch.full((), 7.0, device=dev) for _ in specs]
    records["multi_tensor_adam"] = [measure(
        "multi_tensor_adam", shape, 0.0,
        lambda: mt.adam(grads, rows, **OPT_HYPER, **bc),
        lambda: mt._adam_plain(grads, prow, None, None, None, bc["bc1"],
                               bc["bc2"], h),
        ("torch._fused_adamw_ (fp32, no masters)",
         lambda: torch._fused_adamw_(
             lib_p, lib_g, lib_m, lib_v, [], lib_steps, lr=3e-4, beta1=0.9,
             beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
             maximize=False)),
        nbytes=step_bytes(specs), ops=14.0 * n_el, dtype=torch.float32,
        plain_iters=3)]
    del lib_p, lib_g, lib_m, lib_v
    # O2: fp16 weights and gradients, fp32 masters and moments
    s16 = opt_state(randn, specs_o2, True)
    rows16 = mt.step_rows(s16[0], s16[2], s16[3], s16[4])
    p16 = clone_state(s16)
    prow16 = mt.step_rows(p16[0], p16[2], p16[3], p16[4])
    rec = measure(
        "multi_tensor_adam", f"{len(specs_o2)} tensors, {n_el:,} elements, "
        "O2 (fp16 weights, fp32 masters)", 0.0,
        lambda: mt.adam(s16[1], rows16, **OPT_HYPER, **bc),
        lambda: mt._adam_plain(s16[1], prow16, None, None, None, bc["bc1"],
                               bc["bc2"], h),
        None, nbytes=step_bytes(specs_o2), ops=14.0 * n_el,
        dtype=torch.float32, plain_iters=3)
    base = records["multi_tensor_adam"][0]["ms"]
    log(f"  multi_tensor_adam O2: {rec['ms'] / base:.3f}x the O5 step "
        f"({base:.4f} ms)")
    records["multi_tensor_adam"].append(rec)
    del s16, p16, rows16, prow16
    nk = mt.l2norm(grads, per_tensor=True)
    npl = mt._l2norm_plain(grads, None, True,
                           torch.ones((), dtype=torch.bool, device=dev))
    records["multi_tensor_l2norm"] = [measure(
        "multi_tensor_l2norm", shape + ", bf16/fp32 gradients",
        max_err(nk.per_tensor, npl.per_tensor),
        lambda: mt.l2norm(grads, per_tensor=True),
        lambda: mt._l2norm_plain(grads, None, True, torch.ones(
            (), dtype=torch.bool, device=dev)),
        ("torch._foreach_norm + stack + norm",
         lambda: torch.linalg.vector_norm(torch.stack(
             [n.float() for n in torch._foreach_norm(grads)]))),
        nbytes=g_bytes, ops=2.0 * n_el, dtype=torch.float32, plain_iters=3)]
    unit = one(1.0)
    records["multi_tensor_scale"] = [measure(
        "multi_tensor_scale", shape + ", in place, x 1.0", 0.0,
        lambda: mt.scale(grads, unit, out=grads),
        lambda: mt._scale_plain(grads, unit, None, 0.0, grads, torch.ones(
            (), dtype=torch.bool, device=dev)),
        ("torch._foreach_mul_ (without the finite check: "
         "_amp_foreach_non_finite_check_and_unscale_ takes no bf16)",
         lambda: torch._foreach_mul_(grads, unit)),
        nbytes=2 * g_bytes, ops=2.0 * n_el, dtype=torch.float32,
        plain_iters=3)]
    lstate = opt_state(randn, specs, True)
    lrows = mt.step_rows(lstate[0], lstate[2], lstate[3], lstate[4],
                         mt.KERNEL_LAMB)
    lplain = clone_state(lstate)
    lprow = mt.step_rows(lplain[0], lplain[2], lplain[3], lplain[4],
                         mt.KERNEL_LAMB)
    hl = mt._hyper(0.9, 0.999, 0.1, 1e-6, 1e-3, 0.01, True)
    lamb_bytes = step_bytes(specs)
    design = sum(math.prod(s) * ((26 if d == torch.bfloat16 else 28)
                                 + (14 if d == torch.bfloat16 else 16))
                 for s, d in specs)
    log(f"  multi_tensor_lamb: the function moves {lamb_bytes:,} bytes "
        f"(its bound); the two-stage design moves {design:,} (u written "
        "and read back in fp32)")
    records["multi_tensor_lamb"] = [measure(
        "multi_tensor_lamb", shape,
        errs[("flagship", "lamb", "trust ratios")],
        lambda: mt.lamb(lstate[1], lrows, **LAMB_HYPER, **bc),
        lambda: mt._lamb_plain(lstate[1], lprow, None, None, None, bc["bc1"],
                               bc["bc2"], hl, True),
        None, nbytes=lamb_bytes, ops=20.0 * n_el, dtype=torch.float32,
        plain_iters=3)]
    log("  multi_tensor_lamb: no PyTorch call computes LAMB (no library "
        "column)")
    del state, plain_state, lstate, lplain
    torch.cuda.empty_cache()
    return records


# ---------------------------------------------------------- train-amp
def opt_snapshot(tr) -> tuple:
    """Device copies of a trainer's parameters, optimizer state (per
    parameter, fp32 copies out of the packed buffers for a fused tail),
    step counter and scaler state."""
    unpacked = tr.opt.unpack_state()
    params = [p.detach().clone() for p in tr.model.parameters()]
    state = {k: [None if t is None else t.detach().clone() for t in v]
             for k, v in unpacked.items() if k != "step"}
    sc = tr.amp_state.scaler_states[0]
    return (params, state, unpacked["step"].clone(),
            tuple(t.clone() for t in sc))


def same_snapshot(a, b) -> bool:
    (pa, sa, ka, ca), (pb, sb, kb, cb) = a, b
    return (all(torch.equal(x, y) for x, y in zip(pa, pb))
            and sa.keys() == sb.keys()
            and all(torch.equal(x, y) for k in sa
                    for x, y in zip(sa[k], sb[k]))
            and torch.equal(ka, kb)
            and all(torch.equal(x, y) for x, y in zip(ca, cb)))


def poison(param, where: int):
    """A backward hook that sets one element of ``param``'s gradient (the
    first, ``where=0``, or the last, ``-1``) to inf, as an overflowed
    backward leaves it; returns the hook's handle."""
    def hook(g):
        g = g.clone()
        g.view(-1)[where] = float("inf")
        return g
    return param.register_hook(hook)


def phase_train_amp(dev) -> dict:
    """The flagship trainer (12 layers, 8 x 1024, O5) with the dynamic loss
    scaler, ``amp.initialize("O5", loss_scale="dynamic")``, per-leaf and
    with ``--fused-opt-tail``, the two fed the same gradients each step:
    three steps give the same bits; an inf injected in the backward (the
    first gradient's first element, the fused trainer's last gradient's
    last element) leaves parameters, masters, moments and the step counter
    unchanged bit for bit and halves the scale, and the next step
    proceeds; a ``StepGuard`` sees both steps; one tail under
    ``torch.cuda.set_sync_debug_mode("error")`` makes no host
    synchronisation; ``step_scaled`` (the unscale folded into the fused
    tail's kernel) gives the per-leaf tail's bits.  Returns the launch
    counts of one tail."""
    from apex_tpu_torch.amp import StepGuard
    from apex_tpu_torch.examples import gpt_pretrain
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts

    log("[train-amp] the flagship trainer (12 layers, 8 x 1024, O5) with "
        "amp.initialize('O5', loss_scale='dynamic'), per-leaf and fused "
        "tail, the same gradients each step")
    flags = TRAIN_FLAGSHIP + ["--opt-level", "O5", "--lr", "3e-4",
                              "--device", str(dev)]
    over = dict(loss_scale="dynamic")
    leaf = gpt_pretrain.Trainer(gpt_pretrain.parse_args(flags), over)
    fused = gpt_pretrain.Trainer(gpt_pretrain.parse_args(
        flags + ["--fused-opt-tail"]), over)
    batch = leaf.to_device(*gpt_pretrain.batches(
        np.random.default_rng(0), 1, leaf.global_batch, leaf.args.seq,
        leaf.args.vocab)[0])
    guard = StepGuard(scaler=leaf.mp.scaler)

    def both(hooks=()):
        """One step of each: the per-leaf trainer's backward, its
        gradients handed to the fused trainer, both tails."""
        handles = [poison(leaf_p, where) for leaf_p, where in hooks]
        loss = leaf.backward(*batch)
        for h in handles:
            h.remove()
        fused.opt.zero_grad(set_to_none=True)
        for a, b in zip(leaf.model.parameters(), fused.model.parameters()):
            b.grad = None if a.grad is None else a.grad.clone()
        if hooks:
            # the fused trainer's poison at its last gradient's last element
            last = [p for p in fused.model.parameters()
                    if p.grad is not None][-1]
            last.grad.view(-1)[-1] = float("inf")
        leaf.tail()
        fused.tail()
        return loss

    losses = [both() for _ in range(3)]
    if not same_snapshot(opt_snapshot(leaf), opt_snapshot(fused)):
        fail("train-amp: the fused tail's parameters or state differ from "
             "the per-leaf path's after 3 steps")
    log(f"  3 steps: losses {[round(float(x), 5) for x in losses]}, fused "
        f"tail == per-leaf bit for bit ({len(fused.opt._tail.plan.names)} "
        "buckets)")
    before = [opt_snapshot(t) for t in (leaf, fused)]
    scale0 = float(leaf.amp_state.scaler_states[0].loss_scale)
    first = next(iter(leaf.model.parameters()))
    both(hooks=[(first, 0)])
    for name, tr, snap in (("per-leaf", leaf, before[0]),
                           ("fused", fused, before[1])):
        after = opt_snapshot(tr)
        scale1 = float(tr.amp_state.scaler_states[0].loss_scale)
        if bool(tr.finite) or not same_snapshot(
                (after[0], after[1], after[2], ()),
                (snap[0], snap[1], snap[2], ())):
            fail(f"train-amp: the {name} trainer's overflowed step moved "
                 "its parameters or state")
        if scale1 != scale0 / 2:
            fail(f"train-amp: the {name} scale went {scale0} -> {scale1}, "
                 "not halved")
    v_bad = guard.observe(leaf.finite, step=4,
                          scaler_state=leaf.amp_state.scaler_states[0])
    log(f"  overflow at step 4: skipped, every bit kept, scale {scale0:g} "
        f"-> {scale0 / 2:g}; guard {v_bad.action} "
        f"(consecutive_bad {v_bad.consecutive_bad})")
    steps_before = int(leaf.opt.unpack_state()["step"])
    loss = both()
    v_ok = guard.observe(leaf.finite, step=5,
                         scaler_state=leaf.amp_state.scaler_states[0])
    if not (bool(leaf.finite) and math.isfinite(float(loss))
            and int(leaf.opt.unpack_state()["step"]) == steps_before + 1
            and guard.total_bad == 1 and v_ok.consecutive_bad == 0
            and v_bad.consecutive_bad == 1):
        fail("train-amp: the step after the overflow did not proceed, or "
             "the guard missed a step")
    if not same_snapshot(opt_snapshot(leaf), opt_snapshot(fused)):
        fail("train-amp: per-leaf and fused tails differ after the overflow")
    log(f"  step 5 proceeds (loss {float(loss):.5f}, counter "
        f"{steps_before} -> {steps_before + 1}); guard ok, total_bad "
        f"{guard.total_bad}")
    # a step of each with the tails under the sync debug mode
    hand = lambda: [setattr(b, "grad", a.grad.clone()) for a, b in zip(
        leaf.model.parameters(), fused.model.parameters())]
    leaf.backward(*batch)
    fused.opt.zero_grad(set_to_none=True)
    hand()
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        leaf.tail()
        fused.tail()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = {k: v // 2 for k, v in launch_counts().items() if v}
    log(f"  both tails under set_sync_debug_mode('error'): no host "
        f"synchronisation; launches a tail {counts}")
    # step_scaled: the unscale folded into the fused tail's kernel read
    leaf.backward(*batch)
    fused.opt.zero_grad(set_to_none=True)
    hand()
    leaf.tail()
    sc = fused.amp_state.scaler_states[0]
    finite = fused.opt.step_scaled(fused.mp.scaler.inv_scale(sc))
    fused.amp_state = fused.amp_state._replace(
        scaler_states=(fused.mp.scaler.adjust(sc, finite),))
    if not (bool(finite) and same_snapshot(opt_snapshot(leaf),
                                           opt_snapshot(fused))):
        fail("train-amp: step_scaled's folded unscale differs from the "
             "per-leaf unscale and step")
    log("  step_scaled (the unscale folded into multi_tensor_adam's read) "
        "== unscale_and_adjust + step, bit for bit")
    del leaf, fused
    torch.cuda.empty_cache()
    # LAMB at the flagship: FusedMixedPrecisionLamb through step_scaled
    from apex_tpu_torch.optimizers import FusedMixedPrecisionLamb

    tr = gpt_pretrain.Trainer(gpt_pretrain.parse_args(flags), over)
    tr.opt = FusedMixedPrecisionLamb(tr.model.parameters(), lr=2e-3)
    torch.cuda.synchronize()
    reset_launch_counts()
    losses = []
    for _ in range(3):
        losses.append(tr.backward(*batch))
        sc = tr.amp_state.scaler_states[0]
        finite = tr.opt.step_scaled(tr.mp.scaler.inv_scale(sc))
        tr.amp_state = tr.amp_state._replace(
            scaler_states=(tr.mp.scaler.adjust(sc, finite),))
    torch.cuda.synchronize()
    lamb_counts = {k: v for k, v in launch_counts().items() if v}
    losses = [float(x) for x in losses]
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
            and bool(finite)):
        fail(f"train-amp: FusedMixedPrecisionLamb losses {losses} are not "
             "finite and falling")
    log(f"  FusedMixedPrecisionLamb (lr 2e-3, clip 1.0) through step_scaled, "
        f"3 steps: losses {[round(x, 5) for x in losses]}; launches "
        f"{lamb_counts}")
    del tr
    torch.cuda.empty_cache()
    return dict(counts, **{k: lamb_counts.get(k, 0) for k in (
        "multi_tensor_l2norm", "multi_tensor_lamb")})


#: name -> (route, source, the TPU kernel it replaces); the forwards'
#: records are bf16, whose kernel is attention_fwd_sm90.cuh (the entries'
#: fp32 instances stay in their .cu files)
# ------------------------------------------------------- fp16 (O1-O3)
#: train-fp16-parity's GPT: 2 layers, hidden 128, one head of 128 (the
#: flagship's head width), vocab 512, 384 tokens a step (the short rung):
#: the CPU's fp16 matrix products run at about 2 GFLOP/s on the card's
#: host (this phase spent 430 s at hidden 512), so the CPU side is kept
#: to some 1.4 GFLOP a step
FP16_PARITY_FLAGS = ["--layers", "2", "--hidden", "128", "--heads", "1",
                     "--vocab", "512", "--seq", "384", "--micro-batch",
                     "1", "--num-micro", "1", "--lr", "1e-3"]
FP16_PARITY_STEPS = 4
#: the step (from 0) whose backward leaves an inf in the first gradient
FP16_POISONED_STEP = 2
#: the instances each O2 step of train-fp16-parity must launch: the GPT
#: with dropout, BERT with padding, contrib attention with a float mask
FP16_PARITY_NEED = {
    "dropout": ("short_fwd_drop_f16", "short_bwd_drop_f16", "dropout_f16"),
    "bert": ("short_fwd_seg_f16", "short_bwd_seg_f16"),
    "mha": ("short_fwd_bias_f16", "short_bwd_bias_f16",
            "short_fwd_seg_drop_bias_f16", "short_bwd_seg_drop_bias_f16")}
#: fp16 bands of a GPU step against the CPU's, from the same weights,
#: data and state: the loss to 5e-3 of its magnitude (fp16 activations,
#: 2**-11 relative a rounding, averaged by the mean); a gradient to 2e-2 of
#: its tensor's largest (fp16 activations through two layers, and the
#: kernels' fp16 P and dz * scale operands where the plain versions keep
#: P in fp32); an updated parameter to 1% of the learning rate plus one
#: ulp of its dtype where the gradient's sign is sure, within a step of
#: where it was elsewhere
FP16_LOSS_REL = 5e-3
FP16_GRAD_REL = 2e-2


def check_fp16_step(label, gpu, cpu, before, lr) -> tuple:
    """Hold one fp16 training step on the GPU against the CPU's within
    the bands above: ``gpu``/``cpu`` are ``(loss, {name: grad}, {name:
    param after})``, the gradients those the optimizer took (unscaled).
    Returns ``(worst grad error, worst step error, sure elements)``, each
    error as a share of its band."""
    (lg, gg, pg), (lc, gc, pc) = gpu, cpu
    if not abs(lg - lc) <= FP16_LOSS_REL * max(1.0, abs(lc)):
        fail(f"{label}: loss {lg} (GPU) vs {lc} (CPU), band "
             f"{FP16_LOSS_REL:g} of it")
    worst_g, worst_p, n_sure = 0.0, 0.0, 0
    for n in gc:
        g_c, g_g = gc[n].float(), gg[n].float()
        tol = FP16_GRAD_REL * g_c.abs().max().item() + 1e-12
        err = (g_g - g_c).abs().max().item()
        if not err <= tol:
            fail(f"{label}: grad {n} differs by {err:.3g} > {tol:.3g}")
        worst_g = max(worst_g, err / tol)
        sure = g_c.abs() >= max(10 * tol, 1e-6)
        band = 1e-2 * lr + ulp_of(pc[n])
        dp = (pg[n].float() - pc[n].float()).abs()
        n_sure += int(sure.sum())
        if sure.any():
            worst_p = max(worst_p, (dp[sure] / band[sure]).max().item())
            if (dp[sure] > band[sure]).any():
                fail(f"{label}: updated {n} differs by "
                     f"{dp[sure].max().item():.3g} where the step is sure")
        moved = (pg[n].float() - before[n].float()).abs()
        if (moved > 1.001 * lr + ulp_of(before[n])).any():
            fail(f"{label}: {n} moved by {moved.max().item():.3g} > lr")
    return worst_g, worst_p, n_sure


def snapshot(model, grads: bool = False) -> dict:
    """The parameters (or their gradients, where there is one) on the
    CPU."""
    out = {}
    for n, p in model.named_parameters():
        t = p.grad if grads else p
        if t is not None:
            out[n] = t.detach().cpu().clone()
    return out


def amp_step(model, loss_fn, level: str, lr: float) -> tuple:
    """One step of ``model`` at ``level`` with the dynamic loss scaler, as
    the trainer takes it: the scaled loss's backward, the scaler's
    unscale and overflow check, FusedAdam (fp32 masters where the level
    keeps them) skipped on an overflow.  ``((loss, grads, params), finite)``
    on the CPU."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedAdam

    mp = amp.initialize(level, loss_scale="dynamic")
    dev = next(model.parameters()).device
    state = mp.init(device=dev)
    opt = FusedAdam(model.parameters(), lr=lr,
                    master_weights=mp.policy.master_weights)
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model)
    mp.scale_loss(state, loss).backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    _, finite, state = mp.unscale_and_adjust(state, grads)
    opt.step(grads_finite=finite)
    return ((float(loss.detach()), snapshot(model, True), snapshot(model)),
            bool(finite))


def gpu_cpu_step(label, build, loss_fn, level, lr, dev) -> dict:
    """``build(device)`` a model on the GPU and the CPU with the GPU's
    weights, one :func:`amp_step` each, held to the fp16 bands; returns
    the GPU step's launches."""
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts

    gpu, cpu = build(dev), build("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    before = snapshot(gpu)
    torch.cuda.synchronize()
    reset_launch_counts()
    got, fin_g = amp_step(gpu, loss_fn, level, lr)
    torch.cuda.synchronize()
    counts = launch_counts()
    want, fin_c = amp_step(cpu, loss_fn, level, lr)
    if not (fin_g and fin_c):
        fail(f"{label}: a step overflowed (GPU finite {fin_g}, CPU {fin_c})")
    worst_g, worst_p, n_sure = check_fp16_step(label, got, want, before, lr)
    log(f"  {label}: loss {got[0]:.5f} (GPU) vs {want[0]:.5f} (CPU); grads "
        f"within {worst_g:.3f} of their band, updated params within "
        f"{worst_p:.3f} of theirs at {n_sure} sure-sign elements; launches "
        f"{({k: v for k, v in counts.items() if v})}")
    del gpu, cpu
    return counts


def phase_train_fp16_parity(dev) -> dict:
    """The fp16 levels against the CPU.  A 2-layer GPT
    (:data:`FP16_PARITY_FLAGS`) through the port trainer at O1 (fp32
    params, fp16 compute), O2 (fp16 params, fp32 norms and masters) and
    O3 (pure fp16), each with the dynamic loss scaler, 4 steps on the GPU
    and on a CPU copy from the same weights and batches: step 1's loss,
    every gradient and the updated parameters within the fp16 bands
    (:func:`check_fp16_step`); every step's loss within twice the loss
    band; the same steps skipped on both, the poisoned step 3 (an inf in
    the first gradient's backward) skipped on both with the parameters
    unchanged bit for bit on the card and the scale halved on both, and
    step 4 taken.  Then one O2 step each, GPU against CPU: the GPT with
    hidden and attention dropout 0.1 on one key (the dropout instances
    and the hidden-dropout kernel), BERT with padding (the segment-id
    instances) and contrib ``SelfMultiheadAttn`` with a float mask, and
    with the key padding and dropout beside it (the bias instances).
    Returns the launches of each part."""
    from apex_tpu_torch.amp import get_policy
    from apex_tpu_torch.contrib.multihead_attn import SelfMultiheadAttn
    from apex_tpu_torch.examples import gpt_pretrain
    from apex_tpu_torch.models import (BertConfig, BertModel, GPTConfig,
                                       GPTModel)
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.random import PRNGKey

    log(f"[train-fp16-parity] gpt_pretrain {' '.join(FP16_PARITY_FLAGS)} "
        f"at O1, O2, O3 with dynamic loss scaling: {FP16_PARITY_STEPS} steps "
        f"on the GPU vs the CPU, step {FP16_POISONED_STEP + 1} poisoned")
    counts = {}
    for level in ("O1", "O2", "O3"):
        trs = [gpt_pretrain.Trainer(gpt_pretrain.parse_args(
            FP16_PARITY_FLAGS + ["--opt-level", level, "--device", d]),
            dict(loss_scale="dynamic")) for d in (str(dev), "cpu")]
        gpu, cpu = trs
        cpu.model.load_state_dict({k: v.cpu() for k, v in
                                   gpu.model.state_dict().items()})
        data = gpt_pretrain.batches(np.random.default_rng(1),
                                    FP16_PARITY_STEPS, gpu.global_batch,
                                    gpu.args.seq, gpu.args.vocab)
        lr = gpu.args.lr
        torch.cuda.synchronize()
        reset_launch_counts()
        rows = []
        for i in range(FP16_PARITY_STEPS):
            step = []
            for tr in trs:
                before = snapshot(tr.model)
                hooks = ([poison(next(tr.model.parameters()), 0)]
                         if i == FP16_POISONED_STEP else [])
                loss = tr.backward(*tr.to_device(*data[i]))
                for hd in hooks:
                    hd.remove()
                tr.tail()
                step.append(((float(loss), snapshot(tr.model, True),
                              snapshot(tr.model)), bool(tr.finite),
                             float(tr.amp_state.scaler_states[0].loss_scale),
                             before))
            (g, fin_g, sc_g, bef_g), (c, fin_c, sc_c, _) = step
            rows.append((fin_g, sc_g))
            if i == 0:
                worst_g, worst_p, n_sure = check_fp16_step(
                    f"train-fp16-parity {level} step 1", g, c, bef_g, lr)
                log(f"  {level} step 1: loss {g[0]:.5f} (GPU) vs {c[0]:.5f}"
                    f" (CPU); grads within {worst_g:.3f} of their band, "
                    f"updated params within {worst_p:.3f} of theirs at "
                    f"{n_sure} sure-sign elements")
            if not abs(g[0] - c[0]) <= 2 * FP16_LOSS_REL * max(1.0,
                                                               abs(c[0])):
                fail(f"train-fp16-parity {level} step {i + 1}: loss {g[0]} "
                     f"(GPU) vs {c[0]} (CPU)")
            if fin_g != fin_c or sc_g != sc_c:
                fail(f"train-fp16-parity {level} step {i + 1}: the GPU "
                     f"{'took' if fin_g else 'skipped'} it (scale {sc_g:g}),"
                     f" the CPU {'took' if fin_c else 'skipped'} it (scale "
                     f"{sc_c:g})")
            if i == FP16_POISONED_STEP:
                prev = rows[i - 1][1]
                same = all(torch.equal(g[2][n], bef_g[n]) for n in bef_g)
                if fin_g or not same or sc_g != prev / 2:
                    fail(f"train-fp16-parity {level}: the poisoned step was "
                         f"taken ({fin_g}) or moved a parameter "
                         f"({not same}), or the scale went {prev:g} -> "
                         f"{sc_g:g}")
            if i == FP16_POISONED_STEP + 1 and not fin_g:
                fail(f"train-fp16-parity {level}: the step after the "
                     "overflow was skipped too")
        torch.cuda.synchronize()
        counts[level] = launch_counts()
        skipped = [i + 1 for i, (f, _) in enumerate(rows) if not f]
        log(f"  {level}: steps skipped on both {skipped}, scales "
            f"{' '.join(f'{s:g}' for _, s in rows)} on both; launches "
            f"{({k: v for k, v in counts[level].items() if v})}")
        for name in ("short_fwd_f16", "short_bwd_f16") + LN_TRAIN:
            if counts[level].get(name, 0) <= 0:
                fail(f"train-fp16-parity {level}: {name} never launched")
        del trs, gpu, cpu
    small = dict(vocab_size=512, num_layers=2, hidden_size=128,
                 num_attention_heads=1, max_position_embeddings=384)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, 512, (1, 384)))
    key = PRNGKey(13)
    counts["dropout"] = gpu_cpu_step(
        "O2 GPT, dropout 0.1/0.1",
        lambda d: GPTModel(GPTConfig(**small, policy=get_policy("O2"),
                                     hidden_dropout=0.1,
                                     attention_dropout=0.1), device=d,
                           seed=4),
        lambda m: m.loss(toks.to(m.device), toks.roll(-1, 1).to(m.device),
                         rng=key), "O2", 1e-3, dev)
    bert = dict(vocab_size=512, num_layers=2, hidden_size=128,
                num_attention_heads=2, max_position_embeddings=256)
    data = bert_batch(np.random.default_rng(3), 2, 256, 512, lo=64)
    counts["bert"] = gpu_cpu_step(
        "O2 BERT, padding as segment ids",
        lambda d: BertModel(BertConfig(**bert, policy=get_policy("O2")),
                            device=d, seed=6),
        lambda m: m.loss(*(torch.as_tensor(a, device=m.device)
                           for a in data)), "O2", 1e-3, dev)
    e, heads, s, b = 128, 2, 128, 4
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(s, b, e, generator=gen).half()
    mask = 0.5 * torch.randn(b, 1, s, s, generator=gen)
    pad = torch.zeros(b, s, dtype=torch.bool)
    pad[1, 2 * s // 3:] = True
    dout = torch.randn(s, b, e, generator=gen)
    counts["mha"] = {}
    for label, kw in (("float mask", dict(attn_mask=mask)),
                      ("float mask, padding, dropout 0.1",
                       dict(attn_mask=mask, key_padding_mask=pad,
                            rng=PRNGKey(21)))):
        on = lambda t, d: t.to(d) if isinstance(t, torch.Tensor) else t
        c = gpu_cpu_step(
            f"O2 SelfMultiheadAttn, {label}",
            lambda d: SelfMultiheadAttn(
                e, heads, bias=True, include_norm_add=True, dropout=0.1,
                policy=get_policy("O2"), device=d, key=PRNGKey(3)),
            lambda m, kw=kw: (m(x.to(m.qkv_weight.device), **{
                n: on(t, m.qkv_weight.device) for n, t in kw.items()}).float()
                * dout.to(m.qkv_weight.device)).mean(), "O2", 1e-3, dev)
        for n, v in c.items():
            counts["mha"][n] = counts["mha"].get(n, 0) + v
    for part, names in FP16_PARITY_NEED.items():
        for name in names:
            if counts[part].get(name, 0) <= 0:
                fail(f"train-fp16-parity {part}: {name} never launched")
    torch.cuda.empty_cache()
    return counts


@contextlib.contextmanager
def patched(obj, **attrs):
    """``obj``'s attributes set to ``attrs`` inside the block."""
    saved = {name: getattr(obj, name) for name in attrs}
    for name, value in attrs.items():
        setattr(obj, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(obj, name, value)


def phase_fp16_skips(dev, flags=TRAIN_LONG, steps=12,
                     label="train-long-fp16-skips"):
    """The steps an fp16 run skips are the plain version's.  The Llama mode
    at O2 as train-long-fp16 trains it (seed, batch, learning rate), 12
    steps: before each, the same scaled backward from the same state with
    the flash rung's plain versions in place of its kernels
    (``flash_attention``'s ``flash_run_fwd`` / ``flash_run_bwd``, on the
    card, rounding the same operands to fp16) says whether the plain
    version overflows; then the step through the kernels.  The two lists
    of finite flags must be equal; a skipped step's non-finite gradients
    are named.  Returns the kernel steps' flags."""
    from apex_tpu_torch.amp.scaler import all_finite
    from apex_tpu_torch.examples import gpt_pretrain
    from apex_tpu_torch.ops import attention as att
    from apex_tpu_torch.ops import attention_flash as fl

    args = gpt_pretrain.parse_args(flags + [
        "--opt-level", "O2", "--lr", "3e-4", "--device", str(dev)])
    log(f"[{label}] gpt_pretrain {' '.join(flags)} --opt-level O2: each "
        f"of {steps} steps' backward with the flash kernels' plain versions"
        ", then the step through the kernels, from the same state")
    tr = gpt_pretrain.Trainer(args)
    batch = tr.to_device(*gpt_pretrain.batches(
        np.random.default_rng(0), 1, tr.global_batch, args.seq,
        args.vocab)[0])

    def plain_fwd(q, k, v, causal, *, scale, ids, heads, drop, slab):
        return fl._flash_fwd_plain(q, k, v, causal, scale, *ids, heads, drop,
                                   slab)

    def plain_bwd(kernel, q, k, v, dout, lse, delta, causal, *, scale, ids,
                  heads, drop, slab, dbias=False):
        grads = fl._flash_bwd_plain(q, k, v, dout, lse, delta, causal,
                                    scale, *ids, heads, drop, slab, dbias)
        if kernel == fl.KERNEL_DKV:
            return grads[1:3]
        return grads[0], (grads[3].view(-1, heads, *grads[3].shape[1:])
                          if dbias else None)

    params = list(tr.model.named_parameters())
    plain_flags, kernel_flags = [], []
    for i in range(steps):
        with patched(att, flash_run_fwd=plain_fwd, flash_run_bwd=plain_bwd):
            tr.backward(*batch)
        plain_flags.append(bool(all_finite(
            [p.grad for _, p in params if p.grad is not None])))
        tr.step(*batch)
        kernel_flags.append(bool(tr.finite))
        if not kernel_flags[-1]:
            bad = [n for n, p in params if p.grad is not None
                   and not bool(torch.isfinite(p.grad).all())]
            log(f"  step {i + 1} skipped (scale now "
                f"{float(tr.amp_state.scaler_states[0].loss_scale):g}): "
                f"non-finite gradients in {len(bad)} of {len(params)} "
                f"tensors: {', '.join(bad[:8])}"
                + (", ..." if len(bad) > 8 else ""))
    skipped = lambda fl_: [i + 1 for i, f in enumerate(fl_) if not f]
    log(f"  skipped through the kernels {skipped(kernel_flags) or 'none'}, "
        f"through the plain versions {skipped(plain_flags) or 'none'}")
    if kernel_flags != plain_flags:
        fail(f"{label}: the kernels skipped steps {skipped(kernel_flags)}, "
             f"the plain versions {skipped(plain_flags)}")
    del tr, batch
    torch.cuda.empty_cache()
    return kernel_flags


#: fp16-variants: each rung's fp16 instances through the port's
#: ``flash_attention`` (forward, and backward through autograd), one shape
#: a rung: (rung, b, h, s, d), causal
FP16_VARIANT_SHAPES = (("short", 2, 4, 384, 64), ("mid", 1, 4, 768, 128),
                       ("flash", 1, 2, 1280, 128))
#: the backward's band here: four fp16 ulps of each gradient's largest
#: magnitude (each device's backward replays its own forward's out, which
#: the kernel and the plain version round two ulps apart, through delta =
#: rowsum(dO * O)); a bias's gradient to 2e-2 of its largest (the same
#: delta, an fp32 sum over the broadcast batch and heads)
FP16_VARIANT_DBIAS_REL = 2e-2


def phase_fp16_variants(dev) -> dict:
    """Every fp16 instance of the seven attention kernels on the path a
    user takes to it, ``flash_attention`` in fp16 with segment ids (packed
    documents), attention dropout 0.1 and an fp32 bias, constant
    (``bias_requires_grad=False``) or trained (the dBias instances), on
    each rung of :data:`FP16_VARIANT_SHAPES` (``implementation=`` picks the
    rung; the CPU side, every plain version in fp32 over the whole score
    matrix, bounds the lengths): the output and the gradients
    of q, k, v (and the bias) on the GPU against the same call on the CPU
    (the plain versions), the forward within two fp16 ulps
    (:func:`tolerance`), the backward within four (the data's note).
    Returns the launches."""
    from apex_tpu_torch.ops import (flash_attention, launch_counts,
                                    reset_launch_counts)

    log("[fp16-variants] flash_attention in fp16 on each rung: ids x "
        "dropout x (no bias, a constant bias, a trained bias), GPU vs CPU")
    counts = {}
    n = 0
    for rung, b, heads, s, d in FP16_VARIANT_SHAPES:
        gen = torch.Generator().manual_seed(s)
        q, k, v, dout = (torch.randn(b, heads, s, d, generator=gen).half()
                         for _ in range(4))
        ids = segment_ids("docs", b, s, "cpu", seed=s)
        bias0 = torch.randn(1, heads, s, s, generator=gen)
        impl = {"short": "short", "mid": "mid", "flash": "pallas"}[rung]
        for segs in (False, True):
            for drop in (False, True):
                for bias_kind in (None, "const", "trained"):
                    outs = []
                    for device in (dev, torch.device("cpu")):
                        qg, kg, vg = (t.detach().to(device).requires_grad_()
                                      for t in (q, k, v))
                        bias = None if bias_kind is None else \
                            bias0.detach().to(device).requires_grad_(
                                bias_kind == "trained")
                        kw = dict(causal=True, bias=bias,
                                  bias_requires_grad=bias_kind == "trained",
                                  implementation=impl)
                        if segs:
                            kw.update(q_segment_ids=ids[0].to(device),
                                      kv_segment_ids=ids[1].to(device))
                        if drop:
                            kw.update(dropout_rate=DROP_RATE,
                                      dropout_seed=DROP_SEED)
                        if device.type == "cuda":
                            torch.cuda.synchronize()
                            reset_launch_counts()
                        out = flash_attention(qg, kg, vg, **kw)
                        leaves = (qg, kg, vg) + (
                            (bias,) if bias_kind == "trained" else ())
                        grads = torch.autograd.grad(
                            out, leaves, dout.to(device))
                        if device.type == "cuda":
                            torch.cuda.synchronize()
                            for name, c in launch_counts().items():
                                counts[name] = counts.get(name, 0) + c
                        outs.append([out.detach().cpu()]
                                    + [g.detach().cpu() for g in grads])
                    got, want = outs
                    what = (f"{rung} b={b} h={heads} s={s} d={d}"
                            + (" ids" if segs else "")
                            + (" dropout" if drop else "")
                            + (f" {bias_kind} bias" if bias_kind else ""))
                    for label, g, w in zip(("out", "dq", "dk", "dv",
                                            "dbias"), got, want):
                        err = max_err(g, w)
                        tol = (tolerance(w) if label == "out" else
                               FP16_VARIANT_DBIAS_REL * w.abs().max().item()
                               if label == "dbias" else 2 * tolerance(w))
                        if not err <= tol:
                            fail(f"fp16-variants {what} {label}: GPU vs CPU "
                                 f"{err:.3g} > {tol:.3g}")
                    n += 1
        del q, k, v, dout
    log(f"  {n} cases, GPU == CPU within the bands; launches "
        f"{({k: v for k, v in sorted(counts.items()) if v})}")
    missing = [name for name in SOURCES if name.endswith("_f16")
               and name.startswith(("short", "mid", "flash"))
               and counts.get(name, 0) <= 0]
    if missing:
        fail(f"fp16-variants: instances never launched: {missing}")
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------ the fused CE, T5 and ResNet
#: the fused CE's parity cases on the card: (vocab, per-vocab bias,
#: smoothing) at 2 x 512 tokens of hidden 1024, fp32; 32768 walks chunks
#: of 8192, BERT's 30522 chunks of 5087
FUSED_CE_CASES = ((32768, False, 0.0), (30522, True, 0.1))
FUSED_CE_HIDDEN = 1024
FUSED_CE_TOKENS = (2, 512)
#: the bf16 band's tokens (the flagship's micro-batch of 8 x 1024) and
#: the token counts of the op's own fused vs two-step timing
FUSED_CE_BAND_TOKENS = 8 * 1024
FUSED_CE_TIMED_TOKENS = (8 * 1024, 24 * 1024)
#: the flagship trainer's micro-batches of 1024 tokens in train-fused-ce
FUSED_CE_MICRO = (8, 24)


def ce_grads(x, w, b, t, g, **kw) -> tuple:
    """``(loss, dx, dW, dbias or None)`` of ``sum(g * loss)`` through
    ``lm_head_cross_entropy(**kw)`` on fresh leaves of ``x``, ``w`` and
    ``b``."""
    from apex_tpu_torch.transformer.tensor_parallel import (
        lm_head_cross_entropy,
    )

    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    bs = None if b is None else b.clone().requires_grad_()
    loss = lm_head_cross_entropy(xs, ws, t, bias=bs, **kw)
    (loss * g).sum().backward()
    return (loss.detach(), xs.grad, ws.grad,
            None if bs is None else bs.grad)


def ce_check(label: str, got: tuple, want: tuple, loss_tol: float,
             rel: float) -> tuple:
    """Hold ``(loss, dx, dW, dbias)`` against another path's: the losses
    to ``loss_tol`` and each gradient to ``rel`` of its largest value.
    Returns each part's error as a share of its tolerance."""
    shares = []
    for what, a, b in zip(("loss", "dx", "dW", "dbias"), got, want):
        if b is None:
            continue
        tol = loss_tol if what == "loss" else \
            rel * b.float().abs().max().item() + 1e-12
        err = max_err(a.cpu(), b.cpu())
        if not err <= tol:
            fail(f"{label}: {what} differs by {err:.3g} > {tol:.3g}")
        shares.append(f"{what} {err:.3g} ({err / tol:.3f} of {tol:.3g})")
    return shares


def phase_fused_ce_parity(dev) -> None:
    """The fused chunked LM-head cross entropy on the card: fp32 at 2 x
    512 tokens of hidden 1024, vocab 32768 (chunk 8192) and BERT's 30522
    with a bias and smoothing 0.1 (chunk 5087): equal to the two-step path
    on the card and to the fused path on the CPU (the loss to 1e-5, dx,
    dW and dbias to 1e-4 of their largest); then the bf16 band at the
    flagship's width (8 x 1024 tokens, hidden 1024, vocab 32768, O5's
    bf16 hidden and weight): the bf16 fused path against the fused path
    on the fp32 copies of the same values (the loss to 1e-4, dx and dW,
    rounded to bf16 once, within one bf16 ulp of their largest), and the
    two-step path's mean loss, whose logits are bf16, within 1e-2."""
    from apex_tpu_torch.transformer.tensor_parallel import cross_entropy

    log(f"[fused-ce-parity] {FUSED_CE_TOKENS[0]} x {FUSED_CE_TOKENS[1]} "
        f"tokens of hidden "
        f"{FUSED_CE_HIDDEN}, fp32: fused vs two-step on the GPU, GPU vs "
        "CPU; then the bf16 band at the flagship's width")
    gen = torch.Generator().manual_seed(23)
    for vocab, with_bias, smoothing in FUSED_CE_CASES:
        chunk = cross_entropy._largest_chunk_divisor(
            vocab, cross_entropy.FUSED_CE_DEFAULT_CHUNK)
        x = torch.randn(*FUSED_CE_TOKENS, FUSED_CE_HIDDEN, generator=gen)
        w = 0.05 * torch.randn(vocab, FUSED_CE_HIDDEN, generator=gen)
        b = 0.5 * torch.randn(vocab, generator=gen) if with_bias else None
        t = torch.randint(0, vocab, FUSED_CE_TOKENS, generator=gen)
        g = torch.rand(*FUSED_CE_TOKENS, generator=gen)
        on = lambda a: None if a is None else a.to(dev)
        args = [on(a) for a in (x, w, b, t, g)]
        fused = ce_grads(*args, fused=True, smoothing=smoothing)
        two = ce_grads(*args, fused=False, smoothing=smoothing)
        cpu = ce_grads(x, w, b, t, g, fused=True, smoothing=smoothing)
        tol = 1e-5 * max(1.0, two[0].abs().max().item())
        label = (f"vocab {vocab} (chunk {chunk})"
                 + (", bias" if with_bias else "")
                 + (f", smoothing {smoothing}" if smoothing else ""))
        shares = ce_check(f"fused-ce-parity {label}, fused vs two-step",
                          fused, two, tol, 1e-4)
        log(f"  {label}: fused vs two-step on the GPU: {'; '.join(shares)}")
        tol = 1e-5 * max(1.0, cpu[0].abs().max().item())
        shares = ce_check(f"fused-ce-parity {label}, GPU vs CPU", fused,
                          cpu, tol, 1e-4)
        log(f"  {label}: GPU vs CPU: {'; '.join(shares)}")
        del fused, two, cpu, args
    # the bf16 band at the flagship's width
    n, h, vocab = (FUSED_CE_BAND_TOKENS, FLAGSHIP["hidden_size"],
                   FLAGSHIP["vocab_size"])
    x = torch.randn(n, h, generator=gen).to(dev, torch.bfloat16)
    w = (0.05 * torch.randn(vocab, h, generator=gen)).to(dev, torch.bfloat16)
    t = torch.randint(0, vocab, (n,), generator=gen).to(dev)
    g = torch.full((n,), 1.0 / n, device=dev)
    half = ce_grads(x, w, None, t, g, fused=True)
    full = ce_grads(x.float(), w.float(), None, t, g, fused=True)
    two = ce_grads(x, w, None, t, g, fused=False)
    err_loss = max_err(half[0], full[0])
    if not err_loss <= 1e-4:
        fail(f"fused-ce-parity bf16: per-token loss off its fp32 twin by "
             f"{err_loss:.3g} > 1e-4")
    bands = []
    for what, a, b in (("dx", half[1], full[1]), ("dW", half[2], full[2])):
        if a.dtype != torch.bfloat16:
            fail(f"fused-ce-parity bf16: {what} is {a.dtype}, not bf16")
        top = b.abs().max().item()
        err = max_err(a, b)
        if not err <= bf16_ulp(top):
            fail(f"fused-ce-parity bf16: {what} off its fp32 twin by "
                 f"{err:.3g} > one bf16 ulp {bf16_ulp(top):.3g}")
        bands.append(f"{what} {err:.3g} (one ulp {bf16_ulp(top):.3g})")
    mean_two = (two[0].float().mean() - full[0].mean()).abs().item()
    if not mean_two <= 1e-2:
        fail(f"fused-ce-parity bf16: the two-step path's mean loss is "
             f"{mean_two:.3g} off the fused path's")
    log(f"  bf16 band at {n} tokens x vocab {vocab}, hidden {h}: fused "
        f"bf16 vs fused fp32 per-token loss {err_loss:.3g}, "
        f"{'; '.join(bands)}; the two-step path (bf16 logits): per-token "
        f"loss up to {max_err(two[0], full[0]):.3g}, mean loss "
        f"{mean_two:.3g} off")
    # one forward + backward of each path, bf16, at 8 x 1024 and 24 x
    # 1024 tokens: the op's own crossover
    for tokens in FUSED_CE_TIMED_TOKENS:
        xt = torch.randn(tokens, h, device=dev).to(torch.bfloat16)
        tt = torch.randint(0, vocab, (tokens,), device=dev)
        gt = torch.full((tokens,), 1.0 / tokens, device=dev)
        times = {}
        for fused in (True, False):
            run = lambda: ce_grads(xt, w, None, tt, gt, fused=fused)
            run()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            times[fused] = (_events_ms(lambda: [run() for _ in range(5)], 5),
                            (torch.cuda.max_memory_allocated() - base)
                            / 2**30)
        log(f"  forward + backward at {tokens} tokens, bf16: fused "
            f"{times[True][0]:.3f} ms (peak +{times[True][1]:.2f} GiB), "
            f"two-step {times[False][0]:.3f} ms (peak "
            f"+{times[False][1]:.2f} GiB)")
        del xt, tt, gt
    torch.cuda.empty_cache()


def train_steps(step, n_warm: int = 2, n_timed: int = 10) -> tuple:
    """Run ``step`` (returning a device loss) ``n_warm`` + ``n_timed``
    times: ``(losses, ms a timed step, peak GiB over the timed steps,
    launch counts of the timed steps)``."""
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts

    warm = [step() for _ in range(n_warm)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    losses = [step() for _ in range(n_timed)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    losses = [float(x) for x in torch.stack(warm + losses).cpu()]
    return (losses, 1e3 * wall / n_timed,
            torch.cuda.max_memory_allocated() / 2**30, counts)


def phase_train_fused_ce(dev) -> None:
    """The flagship trainer at O5 (``gpt_pretrain``, remat on) at
    micro-batches of 8 x 1024 and 24 x 1024 tokens, each with
    ``fused_ce=True`` and ``False``: 2 warm-up and 10 timed steps each,
    ms/step, tokens/s and peak memory (the card's crossover).  At 24 x
    1024 ``fused_ce=None`` must take the fused path and the fused path's
    peak must be below the two-step path's; the loss must be finite and
    fall."""
    from apex_tpu_torch.examples import gpt_pretrain
    from apex_tpu_torch.transformer.tensor_parallel import cross_entropy

    log("[train-fused-ce] flagship at O5, remat on: fused_ce True vs False "
        "at 8 x 1024 and 24 x 1024 tokens, 2 warm-up + 10 timed steps")
    for micro in FUSED_CE_MICRO:
        flags = ["--seq", "1024", "--micro-batch", str(micro),
                 "--num-micro", "1", "--opt-level", "O5", "--lr", "3e-4",
                 "--device", str(dev)]
        tr = gpt_pretrain.Trainer(gpt_pretrain.parse_args(flags))
        batch = tr.to_device(*gpt_pretrain.batches(
            np.random.default_rng(0), 1, tr.global_batch, 1024,
            tr.args.vocab)[0])
        if micro == FUSED_CE_MICRO[-1]:
            # the auto rule: 24576 tokens x 32768 x 4 B = 3.2 GB > 2 GiB
            real, calls = cross_entropy._FusedCE.apply, []
            spy = lambda *a: calls.append(1) or real(*a)
            tr.model.config.fused_ce = None
            with patched(cross_entropy._FusedCE, apply=spy):
                tr.step(*batch)
            torch.cuda.synchronize()
            if not calls:
                fail(f"train-fused-ce: fused_ce=None at {micro} x 1024 "
                     "did not take the fused path")
            log(f"  {micro} x 1024, fused_ce=None: the fused path "
                f"({len(calls)} call a step), as fused_ce_auto("
                f"{micro * 1024}, {tr.args.vocab}) says")
        peaks = {}
        for fused in (True, False):
            tr.model.config.fused_ce = fused
            losses, ms, peak, _ = train_steps(lambda: tr.step(*batch))
            if not all(math.isfinite(x) for x in losses) or \
                    not losses[-1] < losses[0]:
                fail(f"train-fused-ce {micro} x 1024 fused={fused}: losses "
                     f"{losses} are not finite and falling")
            peaks[fused] = peak
            log(f"  {micro} x 1024, fused_ce={fused}: {ms:.2f} ms/step, "
                f"{tr.tokens_per_step / (ms / 1e3):,.0f} tokens/s, peak "
                f"{peak:.2f} GiB, loss {losses[0]:.4f} -> {losses[-1]:.4f}")
        if micro == FUSED_CE_MICRO[-1] and not peaks[True] < peaks[False]:
            fail(f"train-fused-ce: at {micro} x 1024 the fused path's peak "
                 f"{peaks[True]:.2f} GiB is not below the two-step path's "
                 f"{peaks[False]:.2f} GiB")
        del tr, batch
        torch.cuda.empty_cache()


#: T5 at bench.py's widths (``_t5_extra``): hidden 512, 8 heads (head dim
#: 64), ffn 2048, vocab 32768, 512 positions
T5_WIDTHS = dict(vocab_size=32768, hidden_size=512, num_attention_heads=8,
                 max_position_embeddings=512)
T5_LAYERS, T5_BATCH, T5_SEQ = 6, 16, 512
#: the T5 parity steps: (encoder tokens, decoder tokens), batch 2
T5_PARITY_SEQS = ((256, 256), (384, 200))
T5_KERNELS = ("short_fwd", "short_bwd", "ln_fwd", "ln_bwd")


def t5_batch(rng, b: int, s_enc: int, s_dec: int, vocab: int) -> tuple:
    """``(encoder tokens, decoder tokens, targets)``, uniform ids."""
    return tuple(rng.integers(0, vocab, (b, s)).astype(np.int32)
                 for s in (s_enc, s_dec, s_dec))


def flat_grad(grads: dict) -> torch.Tensor:
    return torch.cat([grads[n].float().flatten() for n in sorted(grads)])


def phase_t5_parity(dev) -> dict:
    """T5 at full width (hidden 512, 8 heads, vocab 32768), 2 + 2 layers:
    one step (loss, backward, FusedAdam) on the GPU through the kernels
    against a CPU copy through the plain versions, fp32 (O0), batch 2 at
    256 + 256 tokens and at 384 encoder + 200 decoder tokens (cross
    attention at sq != sk): ``check_step``'s tolerances; the encoder's
    cross-attention weights get zero gradients on both.  Then the same
    step at O5 (bf16 parameters and compute, fp32 norms and masters) at
    384 + 200: the losses within 0.02, the whole gradient of each within
    3% of its norm of the other's, and every updated parameter within one
    bf16 ulp of the other's where the fp32 gradient's sign is sure.
    Returns the first GPU step's launches."""
    from apex_tpu_torch.amp import get_policy
    from apex_tpu_torch.models import T5Config, T5Model
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedAdam

    lr = 1e-3
    log(f"[t5-parity] T5 widths (hidden {T5_WIDTHS['hidden_size']}, "
        f"{T5_WIDTHS['num_attention_heads']} heads, vocab "
        f"{T5_WIDTHS['vocab_size']}), 2 + 2 layers: one step on the GPU vs "
        f"the CPU, FusedAdam lr={lr}, fp32 then O5")
    counts = None
    for level, seqs in (("O0", T5_PARITY_SEQS), ("O5", T5_PARITY_SEQS[1:])):
        cfg = T5Config(**T5_WIDTHS, num_encoder_layers=2,
                       num_decoder_layers=2, policy=get_policy(level))
        for s_enc, s_dec in seqs:
            data = t5_batch(np.random.default_rng(s_enc), 2, s_enc, s_dec,
                            cfg.vocab_size)
            gpu = T5Model(cfg, device=dev, seed=4)
            cpu = T5Model(cfg, device="cpu", seed=4)
            cpu.load_state_dict({k: v.cpu() for k, v in
                                 gpu.state_dict().items()})
            before = {k: v.cpu().clone() for k, v in
                      gpu.state_dict().items()}
            out = []
            for model in (gpu, cpu):
                opt = FusedAdam(model.parameters(), lr=lr,
                                master_weights=cfg.policy.master_weights)
                batch = [torch.as_tensor(a, device=model.device)
                         for a in data]
                if model is gpu:
                    torch.cuda.synchronize()
                    reset_launch_counts()
                out.append(step_of(model, opt, batch))
                if model is gpu:
                    torch.cuda.synchronize()
                    c = launch_counts()
                    counts = counts or c
            label = f"t5-parity {level} {s_enc} + {s_dec}"
            for (_, grads, _) in out:
                for name, gr in grads.items():
                    if name.startswith("enc_layers.") and "cross" in name \
                            and gr.abs().max().item() != 0.0:
                        fail(f"{label}: encoder cross weight {name} has a "
                             "nonzero gradient")
            if level == "O0":
                worst_g, worst_p, n_sure = check_step(label, *out, before,
                                                      lr)
                log(f"  {level} {s_enc} + {s_dec} tokens: loss "
                    f"{out[0][0]:.6f} (GPU) vs {out[1][0]:.6f} (CPU); every "
                    f"grad within 1e-4 of its scale (worst {worst_g:.3f} "
                    f"of it); updated params within 1% of a step at "
                    f"{n_sure} sure-sign elements (worst {worst_p:.3f})")
            else:
                (lg, gg, pg), (lc, gc, pc) = out
                if not abs(lg - lc) <= 0.02:
                    fail(f"{label}: loss {lg} (GPU) vs {lc} (CPU)")
                err = ((flat_grad(gg) - flat_grad(gc)).norm()
                       / flat_grad(gc).norm()).item()
                if not err <= 0.03:
                    fail(f"{label}: the GPU's gradient is {err:.4f} of its "
                         "norm off the CPU's")
                # a first Adam step moves a weight by about lr * sign(g):
                # where the gradient is a tenth of its tensor's largest or
                # more, both steps land within one ulp of the parameter's
                # type (bf16, or fp32 for the norms) plus 1% of lr
                worst = 0.0
                for name in gc:
                    sure = gc[name].float().abs() >= 0.1 * \
                        gc[name].float().abs().max()
                    band = ulp_of(pc[name][sure]) + 1e-2 * lr
                    off = (pg[name][sure].float() - pc[name][sure].float()
                           ).abs()
                    if (off > band).any():
                        fail(f"{label}: updated {name} differs by "
                             f"{off.max().item():.3g}, past its band")
                    if off.numel():
                        worst = max(worst, (off / band).max().item())
                log(f"  {level} {s_enc} + {s_dec} tokens: loss {lg:.5f} "
                    f"(GPU) vs {lc:.5f} (CPU); whole gradient {err:.5f} of "
                    f"its norm apart; updated params within an ulp + 1% of "
                    f"a step where the gradient is a tenth of its tensor's "
                    f"largest or more (worst {worst:.3f} of it)")
            for name in T5_KERNELS + ("ln_bwd_fold",):
                if c.get(name, 0) <= 0:
                    fail(f"{label}: kernel {name} never launched")
            del gpu, cpu, out
    torch.cuda.empty_cache()
    return counts


def t5_step_flops(cfg, b: int, s_enc: int, s_dec: int, layer_params: int,
                  cross_params: int, kv_params: int) -> int:
    """Model FLOPs of one training step (forward and backward, 3 x the
    forward's 2 per multiply-add): every weight once per token that
    crosses it (an encoder layer's self-attention and MLP over encoder
    tokens, a decoder layer's over decoder tokens and its cross kv over
    encoder tokens, the tied head over decoder tokens) plus the
    attention's score and value products (the encoder's, the decoder's
    and cross attention, causal counted whole as in 12·L·h·s)."""
    h, ne, nd = cfg.hidden_size, b * s_enc, b * s_dec
    enc_w = layer_params - cross_params
    dec_w = layer_params - kv_params
    dense = (ne * cfg.num_encoder_layers * enc_w
             + cfg.num_decoder_layers * (nd * dec_w + ne * kv_params)
             + nd * cfg.vocab_size * h)
    attn = 2 * 2 * h * b * (cfg.num_encoder_layers * s_enc * s_enc
                            + cfg.num_decoder_layers
                            * (s_dec * s_dec + s_dec * s_enc))
    return 3 * (2 * dense + attn)


def phase_t5_train(dev) -> dict:
    """bench.py's ``_t5_extra`` T5 on one card: 6 + 6 layers, hidden 512,
    8 heads, vocab 32768, b=16 x 512 encoder and 512 decoder tokens, bf16
    parameters and compute, remat on, FusedAdam (lr 1e-4, fp32 masters):
    2 warm-up and 10 timed steps on one batch.  The loss must be finite
    and fall, and short_fwd, short_bwd, ln_fwd and ln_bwd must launch.
    Prints ms/step, tokens/s, MFU, peak memory and the launches."""
    from apex_tpu_torch.models import T5Config, T5Model
    from apex_tpu_torch.optimizers import FusedAdam

    b, s = T5_BATCH, T5_SEQ
    cfg = T5Config(**T5_WIDTHS, num_encoder_layers=T5_LAYERS,
                   num_decoder_layers=T5_LAYERS,
                   params_dtype=torch.bfloat16,
                   compute_dtype=torch.bfloat16)
    log(f"[t5-train] T5 {T5_LAYERS} + {T5_LAYERS} layers, hidden "
        f"{cfg.hidden_size}, {cfg.num_attention_heads} heads, vocab "
        f"{cfg.vocab_size}, b={b} x {s} + {s}, bf16, remat on, FusedAdam "
        "lr 1e-4 with fp32 masters: 2 warm-up + 10 timed steps")
    model = T5Model(cfg, device=dev, seed=7)
    opt = FusedAdam(model.parameters(), lr=1e-4, master_weights=True)
    batch = [torch.as_tensor(a, device=dev) for a in t5_batch(
        np.random.default_rng(8), b, s, s, cfg.vocab_size)]
    n_params = sum(p.numel() for p in model.parameters())
    layer = model.enc_layers[0]
    count = lambda mods: sum(p.numel() for m in mods for p in m.parameters())
    flops = t5_step_flops(
        cfg, b, s, s, count([layer]),
        count([layer.ln_cross, layer.cross_q, layer.cross_kv,
               layer.cross_proj]), count([layer.cross_kv]))

    def step():
        opt.zero_grad(set_to_none=True)
        loss = model.loss(*batch)
        loss.backward()
        opt.step()
        return loss.detach()

    losses, ms, peak, counts = train_steps(step)
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"t5-train: losses {losses} are not finite and falling")
    tokens = b * 2 * s
    util = flops / (ms / 1e3) / PEAK_OPS_PER_S[torch.bfloat16]
    log(f"  losses: {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"  {ms:.2f} ms/step, {tokens / (ms / 1e3):,.0f} tokens/s "
        f"(encoder + decoder; {b * s / (ms / 1e3):,.0f} target tokens/s), "
        f"MFU {util:.4f} against the 989 TFLOP/s bf16 dense peak "
        f"({n_params:,} params; {flops:,} model FLOPs a step)")
    log(f"  peak device memory {peak:.2f} GiB")
    log(f"  launches in the 10 timed steps: {counts} (per step: "
        + ", ".join(f"{k} {v / 10:g}" for k, v in sorted(counts.items()))
        + ")")
    for name in T5_KERNELS:
        if counts.get(name, 0) <= 0:
            fail(f"t5-train: kernel {name} never launched on the main path")
    phase_profile_train(types.SimpleNamespace(step=step), (),
                        f"T5 (bf16, {b} x {s} + {s})")
    del model, opt, batch
    torch.cuda.empty_cache()
    return counts


def xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """bench.py's RN50 loss: the mean negative log-softmax of the label
    over fp32 logits."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels[:, None])[:, 0].mean()


#: the ResNet parity cases: (depth, batch, image size, the loss's
#: tolerance, the logits' and running statistics' band and the
#: gradients' band, each band a share of the tensor's largest).
#: ResNet-18's last stage at 32x32 normalizes 2 values a channel, so
#: fp32 rounding in the convolutions alone moves its step by a lot: on
#: the CPU, the convolutions in fp64 against fp32 (this phase's inputs,
#: weights drawn from its seed on the CPU) move the loss by 7.2e-5, the
#: logits by 1.1e-4, the running statistics by 6.8e-4 and the gradients
#: by 2.0e-2 of their largest; it is held to 5x those.  ResNet-50's at 64x64 moves them by
#: 4.8e-7, 1.2e-6, 1.6e-6 and 5.8e-6, and is held to the fp32 defaults.
RESNET_PARITY = ((50, 2, 64, 1e-5, 1e-4, 1e-4),
                 (18, 2, 32, 4e-4, 5e-3, 0.1))


def resnet_step(model, opt, images, labels) -> tuple:
    """One step (training-mode forward, the buffers taking the new
    statistics, backward, the optimizer): ``(loss, {name: grad}, {name:
    param after}, logits, {buffer: value after})`` on the CPU."""
    opt.zero_grad(set_to_none=True)
    logits = model(images, training=True)
    loss = xent(logits, labels)
    loss.backward()
    grads = {n: p.grad.detach().cpu().clone()
             for n, p in model.named_parameters()}
    opt.step()
    return (loss.item(), grads,
            {n: p.detach().cpu().clone() for n, p in model.named_parameters()},
            logits.detach().cpu(),
            {n: b.detach().cpu().clone() for n, b in model.named_buffers()})


def phase_resnet_parity(dev) -> None:
    """ResNet-50 (bottleneck) at 2 x 64x64 and ResNet-18 at 2 x 32x32
    (1000 classes), fp32 (O0), TF32 off: one step on the GPU (cuDNN
    convolutions, the Adam kernel) against a CPU copy: the logits and the
    new running statistics, the loss and the gradients and updated
    parameters (``check_step``) within the case's bands
    (:data:`RESNET_PARITY`); then eval mode (the running statistics) on
    both from the GPU's state after the step, the logits within the
    case's band, the stem's norm equal to a batch norm by the buffers'
    values."""
    from apex_tpu_torch.amp import get_policy
    from apex_tpu_torch.models import ResNet, ResNetConfig
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.utils.convnet import conv_nhwc

    lr = 1e-3
    log("[resnet-parity] one step on the GPU vs the CPU, fp32, TF32 off, "
        f"FusedAdam lr={lr}")
    for depth, b, size, loss_tol, band, grad_band in RESNET_PARITY:
        cfg = ResNetConfig(depth=depth, policy=get_policy("O0"))
        gen = torch.Generator().manual_seed(depth)
        images = torch.randn(b, size, size, 3, generator=gen)
        labels = torch.randint(0, cfg.num_classes, (b,), generator=gen)
        gpu = ResNet(cfg, device=dev, seed=depth)
        cpu = ResNet(cfg, device="cpu", seed=depth)
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        before = {n: p.detach().cpu().clone()
                  for n, p in gpu.named_parameters()}
        out = []
        for model in (gpu, cpu):
            opt = FusedAdam(model.parameters(), lr=lr)
            out.append(resnet_step(model, opt, images.to(model.device),
                                   labels.to(model.device)))
        label = f"resnet-parity ResNet-{depth} {b} x {size}x{size}"
        worst_o = 0.0
        for what, a, b_ in (("logits", out[0][3], out[1][3]),) + tuple(
                (f"buffer {n}", out[0][4][n], out[1][4][n])
                for n in out[1][4]):
            tol = band * b_.abs().max().item() + 1e-9
            if not max_err(a, b_) <= tol:
                fail(f"{label}: {what} differs by {max_err(a, b_):.3g} > "
                     f"{tol:.3g}")
            worst_o = max(worst_o, max_err(a, b_) / tol)
        worst_g, worst_p, n_sure = check_step(
            label, out[0][:3], out[1][:3], before, lr, loss_tol=loss_tol,
            grad_tol=grad_band)
        # eval mode from one state (the two steps' updates differ by up
        # to 2 lr where a gradient is noise): the GPU's parameters and
        # the running statistics its step wrote, on both devices
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        with torch.no_grad():
            ev = [m.apply(None, None, images.to(m.device), training=False)[0]
                  .cpu() for m in (gpu, cpu)]
        tol = band * ev[1].abs().max().item()
        if not max_err(ev[0], ev[1]) <= tol:
            fail(f"{label}: eval logits differ by {max_err(*ev):.3g}")
        # the stem's norm by hand from the buffers, on the card
        bn = gpu.bn_stem
        with torch.no_grad():
            stem = conv_nhwc(images.to(dev), gpu.conv_stem, stride=2)
            want = (stem - bn.mean) * torch.rsqrt(bn.var + cfg.bn_eps) \
                * bn.scale + bn.bias
            got, _ = gpu._bn(bn.params(), bn.stats(), stem, False)
        if not max_err(got, want) <= 1e-5 * want.abs().max().item():
            fail(f"{label}: eval mode does not normalize by the running "
                 "statistics")
        log(f"  ResNet-{depth} {b} x {size}x{size}: loss {out[0][0]:.6f} "
            f"(GPU) vs {out[1][0]:.6f} (CPU); logits and running stats "
            f"within {band:g} of their scale (worst {worst_o:.3f} of it); "
            f"every grad within {grad_band:g} of its scale (worst "
            f"{worst_g:.3f} of it); updated params within 1% of a step at "
            f"{n_sure} sure-sign elements (worst {worst_p:.3f}); eval "
            f"logits within {band:g} (worst {max_err(*ev) / tol:.3f} of "
            "it), normalized by the running statistics")
        del gpu, cpu, out
    torch.cuda.empty_cache()


RN50_BATCH, RN50_SIZE = 64, 224
#: a few steps of the port's example at its default widths
IMAGENET_FLAGS = ["--depth", "50", "--batch-size", "32", "--image-size",
                  "224", "--steps-per-epoch", "6", "--eval-steps", "2"]


def phase_rn50_train(dev) -> dict:
    """bench.py's RN50 on one card: depth 50, batch 64 of 224x224, bf16
    parameters and compute (O5: fp32 norms and Adam masters), local-batch
    statistics, FusedAdam lr 1e-3: 2 warm-up and 10 timed steps on one
    batch; images/s, ms/step, MFU from the convolutions' own FLOPs
    (``ResNet.flops_per_image``, 3 x the forward's), peak memory, a
    finite and falling loss.  Then a few steps of the port's
    ``examples/imagenet_amp`` at depth 50 (fp32 parameters, bf16 compute,
    FusedSGD with masters) and its prec@1 / prec@5."""
    from apex_tpu_torch.amp import get_policy
    from apex_tpu_torch.examples import imagenet_amp
    from apex_tpu_torch.models import ResNet, ResNetConfig
    from apex_tpu_torch.optimizers import FusedAdam

    b, size = RN50_BATCH, RN50_SIZE
    log(f"[rn50-train] ResNet-50, batch {b} x {size}x{size}, O5 (bf16 "
        "parameters and compute, fp32 norms and masters), FusedAdam lr "
        "1e-3: 2 warm-up + 10 timed steps")
    model = ResNet(ResNetConfig(depth=50, policy=get_policy("O5"),
                                sync_bn_axis=None), device=dev, seed=0)
    opt = FusedAdam(model.parameters(), lr=1e-3, master_weights=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.randn(b, size, size, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (b,), generator=gen, device=dev)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = xent(model(images, training=True), labels)
        loss.backward()
        opt.step()
        return loss.detach()

    losses, ms, peak, counts = train_steps(step)
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"rn50-train: losses {losses} are not finite and falling")
    flops = 3 * model.flops_per_image(size) * b
    ips = b / (ms / 1e3)
    util = flops / (ms / 1e3) / PEAK_OPS_PER_S[torch.bfloat16]
    log(f"  losses: {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"  {ms:.2f} ms/step, {ips:,.1f} images/s, MFU {util:.4f} against "
        f"the 989 TFLOP/s bf16 dense peak ({flops / b / 1e9:.2f} GFLOP an "
        f"image, 3 x the convolutions' and fc's forward), peak device "
        f"memory {peak:.2f} GiB; launches {counts}")
    phase_profile_train(types.SimpleNamespace(step=step), (),
                        f"ResNet-50 (O5, {b} x {size}x{size})")
    del model, opt, images, labels
    torch.cuda.empty_cache()
    flags = IMAGENET_FLAGS + ["--device", str(dev)]
    log(f"[rn50-train] imagenet_amp {' '.join(flags)}")
    out = imagenet_amp.main(flags)
    if not all(math.isfinite(x) for x in out["losses"]) or \
            not 0.0 <= out["prec1"] <= out["prec5"] <= 100.0:
        fail(f"rn50-train: imagenet_amp gave {out}")
    log(f"  imagenet_amp: losses {' '.join(f'{x:.4f}' for x in out['losses'])}"
        f"; val prec@1 {out['prec1']:.2f} prec@5 {out['prec5']:.2f}; "
        f"{out['images_per_s']:,.1f} images/s")
    del out
    torch.cuda.empty_cache()
    return dict(ms=ms, images_per_s=ips, mfu=util, peak_gib=peak)


SOURCES = {
    "ln_fwd": ("cuda", "apex_tpu_torch/csrc/layer_norm.cu",
               "apex_tpu/ops/layer_norm.py:66"),
    # the backward replaces XLA code (_normalize_bwd), not a Pallas kernel
    "ln_bwd": ("cuda", "apex_tpu_torch/csrc/layer_norm.cu",
               "apex_tpu/ops/layer_norm.py:168"),
    "ln_bwd_fold": ("cuda", "apex_tpu_torch/csrc/layer_norm.cu",
                    "apex_tpu/ops/layer_norm.py:168"),
    "short_fwd": ("cuda", "apex_tpu_torch/csrc/attention_fwd_sm90.cuh",
                  "apex_tpu/ops/attention_short.py:149"),
    "paged_decode": ("cuda", "apex_tpu_torch/csrc/attention_decode.cu",
                     "apex_tpu/ops/attention_decode.py:210"),
    "short_bwd": ("cuda", "apex_tpu_torch/csrc/attention_bwd_sm90.cuh",
                  "apex_tpu/ops/attention_short.py:215"),
    "mid_fwd": ("cuda", "apex_tpu_torch/csrc/attention_fwd_sm90.cuh",
                "apex_tpu/ops/attention_mid.py:213"),
    "mid_bwd": ("cuda", "apex_tpu_torch/csrc/attention_bwd_sm90.cuh",
                "apex_tpu/ops/attention_mid.py:308"),
    "flash_fwd": ("cuda", "apex_tpu_torch/csrc/attention_fwd_sm90.cuh",
                  "apex_tpu/ops/attention.py:213"),
    "flash_bwd_dkv": ("cuda", "apex_tpu_torch/csrc/attention_bwd_sm90.cuh",
                      "apex_tpu/ops/attention.py:429"),
    "flash_bwd_dq": ("cuda", "apex_tpu_torch/csrc/attention_bwd_sm90.cuh",
                     "apex_tpu/ops/attention.py:534"),
    "dequant_int8": ("cuda", "apex_tpu_torch/csrc/dequant_matmul.cu",
                     "apex_tpu/ops/dequant_matmul.py:97"),
    "dequant_int4": ("cuda", "apex_tpu_torch/csrc/dequant_matmul.cu",
                     "apex_tpu/ops/dequant_matmul.py:107"),
    "paged_decode_int8": ("cuda", "apex_tpu_torch/csrc/attention_decode.cu",
                          "apex_tpu/ops/attention_decode.py:210"),
    "paged_decode_rows": ("cuda", "apex_tpu_torch/csrc/attention_decode.cu",
                          "apex_tpu/ops/attention_decode.py:210"),
    "paged_decode_tree": ("cuda", "apex_tpu_torch/csrc/attention_decode.cu",
                          "apex_tpu/ops/attention_decode.py:210"),
    "softmax_fwd": ("triton", "apex_tpu_torch/ops/softmax.py",
                    "apex_tpu/ops/softmax.py:47"),
    "short_fwd_seg": ("cuda", "apex_tpu_torch/csrc/attention_fwd_sm90.cuh",
                      "apex_tpu/ops/attention_short.py:149"),
    "short_bwd_seg": ("cuda", "apex_tpu_torch/csrc/attention_bwd_sm90.cuh",
                      "apex_tpu/ops/attention_short.py:215"),
    "mid_fwd_seg": ("cuda", "apex_tpu_torch/csrc/attention_fwd_sm90.cuh",
                    "apex_tpu/ops/attention_mid.py:213"),
    "mid_bwd_seg": ("cuda", "apex_tpu_torch/csrc/attention_bwd_sm90.cuh",
                    "apex_tpu/ops/attention_mid.py:308"),
    "flash_fwd_seg": ("cuda", "apex_tpu_torch/csrc/attention_fwd_sm90.cuh",
                      "apex_tpu/ops/attention.py:213"),
    "flash_bwd_dkv_seg": ("cuda", "apex_tpu_torch/csrc/attention_bwd_sm90.cuh",
                          "apex_tpu/ops/attention.py:429"),
    "flash_bwd_dq_seg": ("cuda", "apex_tpu_torch/csrc/attention_bwd_sm90.cuh",
                         "apex_tpu/ops/attention.py:534"),
    # the hidden dropout replaces XLA code, not a Pallas kernel
    "dropout": ("triton", "apex_tpu_torch/ops/dropout.py",
                "apex_tpu/models/gpt.py:806"),
    # the sampler's Gumbel-max draw replaces XLA code, not a Pallas kernel
    "gumbel_argmax": ("triton", "apex_tpu_torch/ops/sampling.py",
                      "apex_tpu/serving/sampling.py:93"),
    "short_fwd_drop": ("cuda", "apex_tpu_torch/csrc/attention_fwd_sm90.cuh",
                       "apex_tpu/ops/attention_short.py:149"),
    "short_bwd_drop": ("cuda", "apex_tpu_torch/csrc/attention_bwd_sm90.cuh",
                       "apex_tpu/ops/attention_short.py:215"),
    "mid_fwd_drop": ("cuda", "apex_tpu_torch/csrc/attention_fwd_sm90.cuh",
                     "apex_tpu/ops/attention_mid.py:213"),
    "mid_bwd_drop": ("cuda", "apex_tpu_torch/csrc/attention_bwd_sm90.cuh",
                     "apex_tpu/ops/attention_mid.py:308"),
    "flash_fwd_drop": ("cuda", "apex_tpu_torch/csrc/attention_fwd_sm90.cuh",
                       "apex_tpu/ops/attention.py:213"),
    "flash_bwd_dkv_drop": ("cuda",
                           "apex_tpu_torch/csrc/attention_bwd_sm90.cuh",
                           "apex_tpu/ops/attention.py:429"),
    "flash_bwd_dq_drop": ("cuda", "apex_tpu_torch/csrc/attention_bwd_sm90.cuh",
                          "apex_tpu/ops/attention.py:534"),
    "short_fwd_seg_drop": ("cuda",
                           "apex_tpu_torch/csrc/attention_fwd_sm90.cuh",
                           "apex_tpu/ops/attention_short.py:149"),
    "short_bwd_seg_drop": ("cuda",
                           "apex_tpu_torch/csrc/attention_bwd_sm90.cuh",
                           "apex_tpu/ops/attention_short.py:215"),
    # the additive bias: a runtime operand of the same kernels
    "short_fwd_bias": ("cuda", "apex_tpu_torch/csrc/attention_fwd_sm90.cuh",
                       "apex_tpu/ops/attention_short.py:149"),
    "short_bwd_bias": ("cuda", "apex_tpu_torch/csrc/attention_bwd_sm90.cuh",
                       "apex_tpu/ops/attention_short.py:215"),
    "mid_fwd_bias": ("cuda", "apex_tpu_torch/csrc/attention_fwd_sm90.cuh",
                     "apex_tpu/ops/attention_mid.py:213"),
    "mid_bwd_bias": ("cuda", "apex_tpu_torch/csrc/attention_bwd_sm90.cuh",
                     "apex_tpu/ops/attention_mid.py:308"),
    "flash_fwd_bias": ("cuda", "apex_tpu_torch/csrc/attention_fwd_sm90.cuh",
                       "apex_tpu/ops/attention.py:213"),
    "flash_bwd_dkv_bias": ("cuda",
                           "apex_tpu_torch/csrc/attention_bwd_sm90.cuh",
                           "apex_tpu/ops/attention.py:429"),
    "flash_bwd_dq_bias": ("cuda", "apex_tpu_torch/csrc/attention_bwd_sm90.cuh",
                          "apex_tpu/ops/attention.py:534"),
    "short_fwd_seg_drop_bias": ("cuda",
                                "apex_tpu_torch/csrc/attention_fwd_sm90.cuh",
                                "apex_tpu/ops/attention_short.py:149"),
    "short_bwd_seg_drop_bias": ("cuda",
                                "apex_tpu_torch/csrc/attention_bwd_sm90.cuh",
                                "apex_tpu/ops/attention_short.py:215"),
    # dBias: the DBIAS instances of the short/mid and flash dQ kernels
    "short_bwd_dbias": ("cuda", "apex_tpu_torch/csrc/attention_bwd_sm90.cuh",
                        "apex_tpu/ops/attention_short.py:215"),
    "short_bwd_seg_drop_dbias": ("cuda",
                                 "apex_tpu_torch/csrc/attention_bwd_sm90.cuh",
                                 "apex_tpu/ops/attention_short.py:215"),
    "mid_bwd_dbias": ("cuda", "apex_tpu_torch/csrc/attention_bwd_sm90.cuh",
                      "apex_tpu/ops/attention_mid.py:308"),
    "flash_bwd_dq_dbias": ("cuda",
                           "apex_tpu_torch/csrc/attention_bwd_sm90.cuh",
                           "apex_tpu/ops/attention.py:534"),
    # the optimizer tail replaces XLA code, not a Pallas kernel
    "multi_tensor_adam": ("cuda", "apex_tpu_torch/csrc/multi_tensor.cu",
                          "apex_tpu/optimizers/fused_adam.py:100"),
    "multi_tensor_l2norm": ("cuda", "apex_tpu_torch/csrc/multi_tensor.cu",
                            "apex_tpu/multi_tensor_apply/__init__.py:121"),
    "multi_tensor_scale": ("cuda", "apex_tpu_torch/csrc/multi_tensor.cu",
                           "apex_tpu/multi_tensor_apply/__init__.py:41"),
    "multi_tensor_lamb": ("cuda", "apex_tpu_torch/csrc/multi_tensor.cu",
                          "apex_tpu/optimizers/fused_lamb.py:101"),
}

# the fp16 instances (O1-O3): the same kernels' fp16 template instances,
# built from the attention_*_f16.cu sources, counted with _f16 last; the
# hidden dropout's fp16 instance
SOURCES.update({name + "_f16": entry for name, entry in list(SOURCES.items())
                if entry[1].endswith("_sm90.cuh")})
SOURCES["dropout_f16"] = SOURCES["dropout"]
# fp16 serving (O1-O3): the paged decode's and the dequant pair's fp16
# instances, built from their _f16 sources
SOURCES.update({name: ("cuda", SOURCES[name[:-4]][1].replace(".cu", "_f16.cu"),
                       SOURCES[name[:-4]][2]) for name in SERVE_F16})

FLASH = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")


def timed(label, fn, *args):
    """Run one phase and log its wall time (the script must end within
    1200 s, and aims at half of that)."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"({label}: {time.perf_counter() - t0:.1f} s)")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke test runs on the GPU")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    card = timed("build", phase_build)
    records = timed("kernels", phase_kernels, dev)
    timed("parity", phase_parity, dev)
    timed("rope-parity", phase_rope_parity, dev)
    timed("quant-parity", phase_quant_parity, dev)
    timed("chunked-parity", phase_chunked_parity, dev)
    timed("sample-parity", phase_sample_parity, dev)
    serve_counts, model, step_s = timed("serve", phase_serve, dev)
    busy = timed("profile", phase_profile, model)
    log("[serve summary] flagship decode, 4 slots (phase 4; busy share "
        "from phase 5's profiled window): "
        + "; ".join(f"{mode} {1e3 * step_s[mode]:.2f} ms/step, device busy "
                    + ("not measured" if busy[mode][0] is None
                       else f"{100 * busy[mode][0]:.1f}%")
                    for mode in ("replayed", "eager"))
        + f"; sampled replayed {1e3 * step_s['sampled, replayed']:.2f}, "
        f"sampled eager {1e3 * step_s['sampled, eager']:.2f} ms/step")
    quant_counts = timed("serve-quant", phase_serve_quant, model)
    chunked_counts = timed("serve-chunked", phase_serve_chunked, model)
    spec_counts = timed("serve-spec", phase_serve_spec, model)
    del model
    torch.cuda.empty_cache()
    softmax_counts = timed("fused-softmax", phase_fused_softmax, dev)
    model = timed("serve-long", phase_serve_long, dev)
    timed("serve-quant-long", phase_serve_quant_long, model)
    timed("serve-chunked-long", phase_serve_chunked_long, model)
    del model
    torch.cuda.empty_cache()
    timed("serve-fp16-parity", phase_serve_fp16_parity, dev)
    serve_fp16_counts = timed("serve-fp16", phase_serve_fp16, dev, step_s)
    parity_counts = timed("train-parity", phase_train_parity, dev)
    train_counts, tr, batch = timed("train", phase_train, dev)
    timed("profile", phase_profile_train, tr, batch)
    del tr, batch
    torch.cuda.empty_cache()
    _, tr, batch = timed("train-fused-tail", phase_train, dev,
                         TRAIN_FLAGSHIP + ["--fused-opt-tail"],
                         "train-fused-tail")
    timed("profile", phase_profile_train, tr, batch,
          "flagship, fused tail (O5, 8 x 1024)")
    del tr, batch
    torch.cuda.empty_cache()
    amp_counts = timed("train-amp", phase_train_amp, dev)
    long_counts, tr, batch = timed(
        "train-long", phase_train, dev, TRAIN_LONG, "train-long",
        LN_TRAIN + FLASH)
    timed("profile", phase_profile_train, tr, batch,
          f"Llama mode (O5, 2 x {LONG_SEQ})")
    del tr, batch
    torch.cuda.empty_cache()
    fp16_parity = timed("train-fp16-parity", phase_train_fp16_parity, dev)
    fp16_counts, tr, batch = timed(
        "train-fp16", phase_train, dev, TRAIN_FLAGSHIP, "train-fp16",
        LN_TRAIN + ("mid_fwd_f16", "mid_bwd_f16", "multi_tensor_adam"), "O2")
    timed("profile", phase_profile_train, tr, batch,
          "flagship (O2: fp16, fp32 norms and masters, 8 x 1024)")
    del tr, batch
    torch.cuda.empty_cache()
    long_fp16_counts, tr, batch = timed(
        "train-long-fp16", phase_train, dev, TRAIN_LONG, "train-long-fp16",
        LN_TRAIN + tuple(n + "_f16" for n in FLASH), "O2")
    del tr, batch
    torch.cuda.empty_cache()
    timed("train-long-fp16-skips", phase_fp16_skips, dev)
    for label in ("train-fp16", "train-long-fp16"):
        o5 = TRAIN_SUMMARY["train" if label == "train-fp16" else
                           "train-long"]
        o2 = TRAIN_SUMMARY[label]
        log(f"[{label} summary] O2 {o2['ms']:.2f} ms/step, "
            f"{o2['tps']:,.0f} tokens/s, MFU {o2['mfu']:.4f}, peak "
            f"{o2['peak_gib']:.2f} GiB, skipped steps "
            f"{o2['skipped'] or 'none'}; O5 in this run {o5['ms']:.2f} "
            f"ms/step, {o5['tps']:,.0f} tokens/s, MFU {o5['mfu']:.4f}, "
            f"peak {o5['peak_gib']:.2f} GiB")
    variant_counts = timed("fp16-variants", phase_fp16_variants, dev)
    drop_parity_counts = timed("train-dropout-parity", phase_train_parity,
                               dev, DROP_RATE, (384, 640))
    drop_counts, tr, batch = timed("train-dropout", phase_train_dropout, dev)
    timed("profile", phase_profile_train, tr, batch,
          f"flagship with dropout {DROP_RATE} (O5, 8 x 1024)")
    del tr, batch
    torch.cuda.empty_cache()
    long_drop_counts, _, _ = timed(
        "train-long-dropout", phase_train_dropout, dev, LLAMA, LONG_SEQ, 2,
        3, "train-long-dropout", tuple(n + "_drop" for n in FLASH))
    torch.cuda.empty_cache()
    seg_drop_counts = timed("seg-dropout", phase_seg_dropout, dev)
    timed("mha-parity", phase_mha_parity, dev)
    mha_counts = timed("mha-train", phase_mha_train, dev)
    mha_rung_counts = timed("mha-rungs", phase_mha_rungs, dev)
    dbias_counts = timed("dbias-train", phase_dbias_train, dev)
    timed("bert-parity", phase_bert_parity, dev)
    bert_counts = timed("bert-train", phase_bert_train, dev)
    timed("bert-finetune", phase_bert_finetune, dev)
    fmha_counts = timed("fmha-varlen", phase_fmha_varlen, dev)
    timed("fused-ce-parity", phase_fused_ce_parity, dev)
    timed("train-fused-ce", phase_train_fused_ce, dev)
    timed("bert-train-fused-ce", phase_bert_train, dev, True,
          "bert-train-fused-ce", False)
    timed("t5-parity", phase_t5_parity, dev)
    t5_counts = timed("t5-train", phase_t5_train, dev)
    log("[t5-train summary] launches of the table's rows 1, 2 and 7 in "
        "the 10 timed steps: " + ", ".join(
            f"{name} {t5_counts.get(name, 0)}"
            for name in ("ln_fwd", "ln_bwd", "ln_bwd_fold", "short_fwd",
                         "short_bwd")))
    timed("resnet-parity", phase_resnet_parity, dev)
    timed("rn50-train", phase_rn50_train, dev)
    # one record per kernel at its main path's shape; launches from the
    # path that carries it: the serving kernels from phase 4, the dequant
    # kernels and int8 pages from serve-quant, short_bwd from the s=384
    # training step of phase 6, the mid kernels and the layer norm's
    # backward from the flagship training of phase 7, the flash kernels from the long-context training of
    # phase 9, the many-row instance from serve-chunked's prefix-cached
    # run, the tree instance from serve-spec's tree run, the softmax from
    # fused-softmax, the short rung's segment instances from bert-train and
    # the mid and flash rungs' from fmha-varlen
    main_counts = dict(serve_counts)
    for name in ("dequant_int8", "dequant_int4", "paged_decode_int8"):
        main_counts[name] = quant_counts.get(name, 0)
    main_counts["short_bwd"] = parity_counts[384].get("short_bwd", 0)
    for name in ("mid_fwd", "mid_bwd", "ln_bwd", "ln_bwd_fold",
                 "multi_tensor_adam"):
        main_counts[name] = train_counts.get(name, 0)
    # the optimizer tail: Adam from phase 7, the scaler's unscale from
    # train-amp's tail, the clip's norm and LAMB from its LAMB steps
    for name in ("multi_tensor_scale", "multi_tensor_l2norm",
                 "multi_tensor_lamb"):
        main_counts[name] = amp_counts.get(name, 0)
    for name in FLASH:
        main_counts[name] = long_counts.get(name, 0)
    main_counts["paged_decode_rows"] = chunked_counts.get(
        "paged_decode_rows", 0)
    main_counts["paged_decode_tree"] = spec_counts.get(
        "paged_decode_tree", 0)
    main_counts["softmax_fwd"] = softmax_counts.get("softmax_fwd", 0)
    for name in ("short_fwd_seg", "short_bwd_seg"):
        main_counts[name] = bert_counts.get(name, 0)
    for name in ("mid_fwd_seg", "mid_bwd_seg", "flash_fwd_seg",
                 "flash_bwd_dkv_seg", "flash_bwd_dq_seg"):
        main_counts[name] = fmha_counts.get(name, 0)
    # dropout: the hidden-dropout kernel and the mid instances from the
    # flagship's dropout training, the flash instances from the Llama
    # mode's, the short pair from the s=384 dropout step of
    # train-dropout-parity, the short segment pair from seg-dropout
    for name in ("dropout", "mid_fwd_drop", "mid_bwd_drop"):
        main_counts[name] = drop_counts.get(name, 0)
    for name in FLASH:
        main_counts[name + "_drop"] = long_drop_counts.get(name + "_drop", 0)
    for name in ("short_fwd_drop", "short_bwd_drop"):
        main_counts[name] = drop_parity_counts[384].get(name, 0)
    for name in ("short_fwd_seg_drop", "short_bwd_seg_drop"):
        main_counts[name] = seg_drop_counts.get(name, 0)
    # the bias instances: the short ones from mha-train (the decoder
    # without padding or dropout, and with both), the mid and flash ones
    # from mha-rungs
    for name in ("short_fwd_bias", "short_bwd_bias",
                 "short_fwd_seg_drop_bias", "short_bwd_seg_drop_bias"):
        main_counts[name] = mha_counts.get(name, 0)
    for name in ("mid_fwd_bias", "mid_bwd_bias") + tuple(
            n + "_bias" for n in FLASH):
        main_counts[name] = mha_rung_counts.get(name, 0)
    # the dBias instances from dbias-train
    for name in ("short_bwd_dbias", "short_bwd_seg_drop_dbias",
                 "mid_bwd_dbias", "flash_bwd_dq_dbias"):
        main_counts[name] = dbias_counts.get(name, 0)
    # fp16 (O1-O3): the short pair from train-fp16-parity's O2 trainer,
    # its dropout, BERT and contrib steps; the mid pair from train-fp16,
    # the flash kernels from train-long-fp16; every other instance from
    # fp16-variants
    fp16_paths = {name: fp16_parity["O2"] for name in ("short_fwd_f16",
                                                        "short_bwd_f16")}
    fp16_paths.update({name: fp16_parity[part] for part, names in
                       FP16_PARITY_NEED.items() for name in names})
    fp16_paths.update({name: fp16_counts for name in ("mid_fwd_f16",
                                                      "mid_bwd_f16")})
    fp16_paths.update({name + "_f16": long_fp16_counts for name in FLASH})
    # fp16 serving: the paged decode and the dequant pair from serve-fp16
    fp16_paths.update({name: serve_fp16_counts for name in SERVE_F16})
    for name in SOURCES:
        if name.endswith("_f16"):
            main_counts[name] = fp16_paths.get(name, variant_counts).get(
                name, 0)
    idle = [name for name in SOURCES if main_counts.get(name, 0) <= 0]
    if idle:
        fail(f"kernels never launched on their main path: {idle}")
    kernels = [dict(name=name, route=route, source=source,
                    replaces=replaces, launches=main_counts[name],
                    **records[name][0])
               for name, (route, source, replaces) in SOURCES.items()]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
