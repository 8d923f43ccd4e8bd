"""GPT pretraining on one GPU: the port's counterpart of
``examples/gpt_pretrain.py`` at tp = pp = dp = 1.

    python -m apex_tpu_torch.examples.gpt_pretrain --steps 20
    python -m apex_tpu_torch.examples.gpt_pretrain --layers 2 --hidden 64 \\
        --heads 2 --vocab 256 --seq 128 --device cpu --steps 3
    python -m apex_tpu_torch.examples.gpt_pretrain --position-embedding rope \\
        --activation swiglu --normalization rmsnorm --seq 4096 \\
        --micro-batch 2 --num-micro 1

The same step as the JAX trainer's single-device path: a precision
policy from ``--opt-level`` through ``amp.initialize`` (O5 by default:
bf16 parameters and compute, fp32 norms, fp32 masters in the optimizer,
no loss scaling; O1-O3 the fp16 levels, O2 fp16 parameters with fp32
norms and masters and a dynamic loss scale), the GPT's mean next-token
cross entropy, its backward through the port's kernels (layer norm, the
short, mid and flash attention rungs, in bf16 or fp16), then the tail:
where the policy has a loss scale (O0's and O3's static 1.0, O1's and
O2's dynamic one) the loss is scaled before the backward and the gradients
unscaled after it, with the overflow check (``unscale_and_adjust``), an
optional global-norm clip (``--clip-grad``) and a ``FusedAdam`` step
that is skipped where the gradients were not finite; the whole tail runs
on the multi-tensor kernels with no host synchronisation.
``--fused-opt-tail`` keeps the optimizer's moments and masters in packed
buckets.  The global batch is ``--micro-batch * --num-micro`` rows of
``--seq`` tokens in one step.  Synthetic tokens come from a numpy seed
as in the JAX trainer: ``--pool`` batches (8 there) drawn once, cycled.
Every ``--log-every`` steps one line gives the loss, ms/step, tokens/s
and MFU (the JAX numerator, ``6·N + 12·L·h·s`` model FLOPs per token, N
counting every parameter -- the SwiGLU gate included, a position table
only where there is one -- over the card's dense bf16 peak); the loss is
read from the device only then.  ``--position-embedding rope`` (with
``--activation swiglu --normalization rmsnorm``, the Llama mode) sets
``max_position_embeddings`` to ``--seq`` as the JAX trainer does; a rope
model keeps no table, so any ``--seq`` runs, past 2048 through the flash
kernels.  ``--device`` defaults to the GPU and raises without one.

Flags of the JAX trainer that the port does not have yet raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from apex_tpu_torch import amp
from apex_tpu_torch.amp.policy import check_ported
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.telemetry.metrics import (
    device_peak_flops,
    mfu,
    transformer_flops_per_token,
)
from apex_tpu_torch.transformer.tensor_parallel import clip_grad_norm
from apex_tpu_torch.utils.platform import resolve_device

__all__ = ["Trainer", "batches", "main", "parse_args", "run"]

#: flags of the JAX trainer that are not ported: ``dest -> (the value
#: that leaves them off, the ROADMAP.md item that brings them)``
UNPORTED = {
    "tp": (1, "queue A item 9 (tensor parallelism)"),
    "pp": (1, "queue A item 9 (pipeline schedules)"),
    "zero": (False, "queue A item 9 (ZeRO)"),
    "zero3": (False, "queue A item 9 (ZeRO-3)"),
    "dp_ici_size": (None, "queue A item 9 (hierarchical data parallelism)"),
    "grad_compression": ("none", "queue A item 9 (quantized collectives)"),
    "compress_ici_legs": (False, "queue A item 9 (quantized collectives)"),
    "no_error_feedback": (False, "queue A item 9 (quantized collectives)"),
    "overlap_grad_sync": (False, "queue A item 9 (overlapped grad sync)"),
    "num_experts": (None, "queue A item 9 (mixture-of-experts)"),
    "data": (None, "queue A item 10 (data)"),
    "checkpoint_dir": (None, "queue A item 10 (checkpointing)"),
    "metrics_jsonl": (None, "queue A item 10 (telemetry)"),
    "trace_dir": (None, "queue A item 10 (telemetry)"),
    "watchdog_s": (None, "queue A item 10 (resilience)"),
}


def batches(rng: np.random.Generator, n_batches: int, global_batch: int,
            seq: int, vocab: int) -> List:
    """Synthetic LM batches as the JAX trainer makes them: uniform ids
    from ``rng``, targets the tokens shifted left by one (wrapping)."""
    pool = []
    for _ in range(n_batches):
        tokens = rng.integers(0, vocab, (global_batch, seq)).astype(np.int32)
        pool.append((tokens, np.roll(tokens, -1, axis=1)))
    return pool


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-micro", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--micro-batch", type=int, default=2,
                    help="rows per microbatch")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--opt-level", default="O5",
                    help="O0-O5: O1-O3 train in fp16 with their loss "
                         "scaler")
    ap.add_argument("--exp-avg-sq-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--activation", default="gelu",
                    choices=["gelu", "swiglu"])
    ap.add_argument("--normalization", default="layernorm",
                    choices=["layernorm", "rmsnorm"])
    ap.add_argument("--clip-grad", type=float, default=None,
                    help="global-norm gradient clipping")
    ap.add_argument("--log-every", type=int, default=10,
                    help="read the loss from the device and print a line "
                         "every N steps")
    ap.add_argument("--pool", type=int, default=8,
                    help="synthetic batches drawn once and cycled")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the kernels' plain "
                         "versions")
    # the JAX trainer's flags that are not ported (see UNPORTED)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--zero", action="store_true")
    ap.add_argument("--zero3", "--param-shard", action="store_true",
                    dest="zero3")
    ap.add_argument("--dp-ici-size", type=int, default=None)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--compress-ici-legs", action="store_true")
    ap.add_argument("--no-error-feedback", action="store_true")
    ap.add_argument("--overlap-grad-sync", action="store_true")
    ap.add_argument("--fused-opt-tail", action="store_true",
                    help="keep the optimizer's moments and masters in "
                         "packed buckets (the fused tail)")
    ap.add_argument("--num-experts", type=int, default=None)
    ap.add_argument("--position-embedding", default="learned",
                    choices=["learned", "rope"])
    ap.add_argument("--data", default=None)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--metrics-jsonl", default=None)
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--watchdog-s", type=float, default=None)
    return ap.parse_args(argv)


def check_flags(args: argparse.Namespace) -> None:
    """Raise for a flag this slice does not port."""
    for dest, (off, item) in UNPORTED.items():
        value = getattr(args, dest)
        if value != off:
            raise NotImplementedError(
                f"--{dest.replace('_', '-')}={value!r} is not ported yet "
                f"(ROADMAP.md {item})")


class Trainer:
    """The model, the optimizer, the amp state and one training step,
    built from the trainer's flags.  Parameters are drawn from seed 0.
    ``amp_overrides`` go to ``amp.initialize`` beside ``--opt-level``
    (``loss_scale="dynamic"`` puts the dynamic scaler on O5)."""

    def __init__(self, args: argparse.Namespace,
                 amp_overrides: Optional[Dict] = None):
        check_flags(args)
        self.args = args
        self.mp = amp.initialize(opt_level=args.opt_level,
                                 **(amp_overrides or {}))
        self.policy = self.mp.policy
        check_ported(self.policy)
        self.device = resolve_device(args.device)
        cfg = GPTConfig(
            vocab_size=args.vocab, num_layers=args.layers,
            hidden_size=args.hidden, num_attention_heads=args.heads,
            max_position_embeddings=args.seq, policy=self.policy,
            position_embedding=args.position_embedding,
            activation=args.activation, normalization=args.normalization)
        self.model = GPTModel(cfg, device=self.device, seed=0)
        self.opt = FusedAdam(
            self.model.parameters(), lr=args.lr,
            master_weights=self.policy.master_weights,
            fused_tail=args.fused_opt_tail,
            exp_avg_sq_dtype=getattr(torch, args.exp_avg_sq_dtype))
        self.use_scaler = self.policy.loss_scale is not None
        self.amp_state = self.mp.init(device=self.device)
        #: the last step's finite flag (a device bool; None without a
        #: loss scale)
        self.finite: Optional[torch.Tensor] = None
        self.n_params = sum(p.numel() for p in self.model.parameters())
        self.global_batch = args.micro_batch * args.num_micro
        self.tokens_per_step = self.global_batch * args.seq
        self.flops_per_token = transformer_flops_per_token(
            self.n_params, args.layers, args.hidden, args.seq)

    def to_device(self, tokens: np.ndarray, targets: np.ndarray):
        return (torch.as_tensor(tokens, device=self.device),
                torch.as_tensor(targets, device=self.device))

    def backward(self, tokens: torch.Tensor,
                 targets: torch.Tensor) -> torch.Tensor:
        """The loss and its backward (scaled where the policy has a loss
        scale); returns the unscaled loss as a device scalar."""
        self.opt.zero_grad(set_to_none=True)
        loss = self.model.loss(tokens, targets)
        if self.use_scaler:
            self.mp.scale_loss(self.amp_state, loss).backward()
        else:
            loss.backward()
        return loss.detach()

    def tail(self) -> None:
        """From the gradients to the updated parameters, as JAX's
        ``train_step``: unscale and adjust the scaler (with a loss scale),
        the optional clip, the step with the finite flag.  No host
        synchronisation."""
        self.finite = None
        if self.use_scaler:
            grads = [p.grad for p in self.model.parameters()
                     if p.grad is not None]
            _, self.finite, self.amp_state = self.mp.unscale_and_adjust(
                self.amp_state, grads)
        if self.args.clip_grad is not None:
            clip_grad_norm(self.model.parameters(), self.args.clip_grad)
        self.opt.step(grads_finite=self.finite)

    def step(self, tokens: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
        """One step, :meth:`backward` then :meth:`tail`.  Returns the loss
        as a device scalar (no host synchronisation)."""
        loss = self.backward(tokens, targets)
        self.tail()
        return loss


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace) -> Dict:
    """Train ``args.steps`` steps; returns the per-step losses and the
    timing of the steps after the first (which builds the kernels)."""
    tr = Trainer(args)
    pool = [tr.to_device(*b) for b in batches(
        np.random.default_rng(0), args.pool, tr.global_batch, args.seq,
        args.vocab)]
    peak = device_peak_flops(tr.device)
    print(f"{tr.n_params:,} parameters, {tr.flops_per_token:,} model FLOPs "
          "per token (6·N + 12·L·h·s; N counts every parameter, the SwiGLU "
          "gate included)", flush=True)
    pending: List[torch.Tensor] = []
    losses: List[float] = []
    t0 = None
    summary: Dict = {}
    for i in range(args.steps):
        pending.append(tr.step(*pool[i % len(pool)]))
        if i == 0:
            _sync(tr.device)
            t0 = time.perf_counter()
        last = i == args.steps - 1
        if (i + 1) % args.log_every == 0 or last:
            losses.extend(float(x) for x in torch.stack(pending).cpu())
            pending = []
            line = f"step {i + 1}  loss {losses[-1]:.4f}"
            if i > 0:
                _sync(tr.device)
                ms = 1e3 * (time.perf_counter() - t0) / i
                tps = tr.tokens_per_step / (ms / 1e3)
                summary = dict(ms_per_step=ms, tokens_per_s=tps,
                               mfu=mfu(tps, tr.flops_per_token, peak))
                line += f"  {ms:.1f} ms/step  {tps:,.0f} tokens/s"
                if summary["mfu"] is not None:
                    line += f"  mfu {summary['mfu']:.3f}"
            print(line, flush=True)
    return dict(losses=losses, n_params=tr.n_params, **summary)


def main(argv: Optional[List[str]] = None) -> Dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
