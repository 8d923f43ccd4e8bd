"""BERT fine-tuning on one GPU, sequence classification with the binary
head: the port's counterpart of ``examples/bert_finetune.py`` at tp = 1.

    python -m apex_tpu_torch.examples.bert_finetune --steps 200
    python -m apex_tpu_torch.examples.bert_finetune --steps 3 --device cpu

The JAX example's single-device path: a ``BertModel`` (bidirectional
encoder, token-0 pooler, padding masks) under the O4 policy (bf16
compute, fp32 parameters and Adam state, the usual fine-tuning precision)
puts its 2-way head on a synthetic classification task and fine-tunes
with ``FusedAdam``.  The task is the JAX example's, drawn from the same
numpy seeds: a sentence's label says whether its first token falls in
the upper half of the vocab, and each sentence is padded to ``--seq`` from
a random length in ``[seq/2, seq]``, so the padding's segment ids reach
every attention call (the short kernel's segment instance on the GPU).
Accuracy climbs from chance to about 1.0 in a few hundred steps.

Every ``--log-every`` steps one line gives the loss and the training
accuracy (read from the device only then); the last lines give ms/step,
sequences/s and the held-out accuracy before and after training.
``--opt-level`` takes every level: at O1-O3 (fp16) the loss is scaled by
the policy's loss scaler and the step skipped where the gradients
overflow, as ``gpt_pretrain`` trains (the JAX example scales no loss).
``--device`` defaults to the GPU and raises without one.  Flags of the
JAX example's multi-chip surface raise ``NotImplementedError`` naming
their ROADMAP.md item, as ``gpt_pretrain.check_flags`` does.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch import amp
from apex_tpu_torch.amp.policy import check_ported
from apex_tpu_torch.examples.gpt_pretrain import UNPORTED as _TRAINER
from apex_tpu_torch.models.bert import BertConfig, BertModel
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.utils.platform import resolve_device

__all__ = ["UNPORTED", "check_flags", "classification_loss", "main",
           "parse_args", "synthetic_task"]

#: the JAX example's flags that are not ported, ``dest -> (the value that
#: leaves them off, the ROADMAP.md item that brings them)``: the trainer's
#: entries for the same flags
UNPORTED = {dest: _TRAINER[dest] for dest in (
    "tp", "zero3", "dp_ici_size", "grad_compression", "compress_ici_legs",
    "no_error_feedback", "overlap_grad_sync", "metrics_jsonl")}


def synthetic_task(rng: np.random.Generator, n_batches: int,
                   global_batch: int, seq: int, vocab: int) -> List:
    """Variable-length sequences, as the JAX example draws them: ``(tokens
    (b, seq) int32, mask (b, seq) bool, labels (b,) int32)`` per batch,
    the label being whether the first token is in the upper vocab
    half."""
    pool = []
    for _ in range(n_batches):
        tokens = rng.integers(1, vocab, (global_batch, seq))
        lengths = rng.integers(seq // 2, seq + 1, (global_batch,))
        mask = np.arange(seq)[None, :] < lengths[:, None]
        tokens = np.where(mask, tokens, 0)
        labels = (tokens[:, 0] >= vocab // 2).astype(np.int32)
        pool.append((tokens.astype(np.int32), mask, labels))
    return pool


def classification_loss(model: BertModel, tokens, mask, labels):
    """``(mean negative log-likelihood, accuracy)`` of the binary head on
    the pooled token 0, as the JAX example's ``cls_loss``."""
    logits = model.binary_logits(model.encode(tokens, attention_mask=mask))
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    acc = (torch.argmax(logits, dim=-1) == labels).float()
    return nll.mean(), acc.mean()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vocab", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4, help="batch rows")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--opt-level", default="O4",
                    help="O0-O5; the fp16 levels O1-O3 with their loss "
                         "scaler")
    ap.add_argument("--log-every", type=int, default=50,
                    help="read the loss and accuracy from the device and "
                         "print a line every N steps")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the kernels' plain "
                         "versions")
    # the JAX example's multi-chip flags (see UNPORTED); --bucket-mb only
    # sizes --overlap-grad-sync's buckets, so it is accepted and unused
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--dp-ici-size", type=int, default=None)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--compress-ici-legs", action="store_true")
    ap.add_argument("--no-error-feedback", action="store_true")
    ap.add_argument("--zero3", "--param-shard", action="store_true",
                    dest="zero3")
    ap.add_argument("--fused-opt-tail", action="store_true",
                    help="keep the optimizer's state in packed buckets")
    ap.add_argument("--overlap-grad-sync", action="store_true")
    ap.add_argument("--bucket-mb", type=float, default=4.0)
    ap.add_argument("--metrics-jsonl", default=None)
    return ap.parse_args(argv)


def check_flags(args: argparse.Namespace) -> None:
    """Raise for a flag this slice does not port."""
    for dest, (off, item) in UNPORTED.items():
        value = getattr(args, dest)
        if value != off:
            raise NotImplementedError(
                f"--{dest.replace('_', '-')}={value!r} is not ported yet "
                f"(ROADMAP.md {item})")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _accuracy(model, pool) -> float:
    with torch.no_grad():
        return float(np.mean([classification_loss(model, *b)[1].item()
                              for b in pool]))


def main(argv: Optional[List[str]] = None) -> Dict:
    """Fine-tune ``--steps`` steps.  Returns the per-step losses and
    training accuracies, the timing of the steps after the first (which
    builds the kernels), and the held-out accuracy before and after."""
    args = parse_args(argv)
    check_flags(args)
    mp = amp.initialize(opt_level=args.opt_level)
    policy = mp.policy
    check_ported(policy)
    device = resolve_device(args.device)
    cfg = BertConfig(
        vocab_size=args.vocab, num_layers=args.layers,
        hidden_size=args.hidden, num_attention_heads=args.heads,
        max_position_embeddings=args.seq, policy=policy,
        add_binary_head=True)
    model = BertModel(cfg, device=device, seed=0)
    opt = FusedAdam(model.parameters(), lr=args.lr,
                    master_weights=policy.master_weights,
                    fused_tail=args.fused_opt_tail)
    on_device = lambda pool: [tuple(torch.as_tensor(x, device=device)
                                    for x in b) for b in pool]
    # a pool large enough that most of the vocab appears in position 0,
    # so the held-out accuracy measures the rule, not memorized rows
    train_pool = on_device(synthetic_task(np.random.default_rng(0), 64,
                                          args.batch, args.seq, args.vocab))
    eval_pool = on_device(synthetic_task(np.random.default_rng(1),
                                         args.eval_batches, args.batch,
                                         args.seq, args.vocab))
    before = _accuracy(model, eval_pool)
    scaled = policy.loss_scale is not None
    amp_state = mp.init(device=device)

    pending: List[torch.Tensor] = []
    losses: List[float] = []
    accs: List[float] = []
    t0 = None
    for i in range(args.steps):
        opt.zero_grad(set_to_none=True)
        loss, acc = classification_loss(model, *train_pool[i % len(train_pool)])
        finite = None
        if scaled:
            mp.scale_loss(amp_state, loss).backward()
            _, finite, amp_state = mp.unscale_and_adjust(
                amp_state, [p.grad for p in model.parameters()
                            if p.grad is not None])
        else:
            loss.backward()
        opt.step(grads_finite=finite)
        pending.append(torch.stack([loss.detach(), acc.detach()]))
        if i == 0:
            _sync(device)
            t0 = time.perf_counter()
        if (i + 1) % args.log_every == 0 or i == args.steps - 1:
            rows = torch.stack(pending).cpu().tolist()
            pending = []
            losses += [r[0] for r in rows]
            accs += [r[1] for r in rows]
            print(f"step {i + 1}  loss {losses[-1]:.4f}  train_acc "
                  f"{accs[-1]:.3f}", flush=True)
    summary: Dict = {}
    if args.steps > 1:
        _sync(device)
        ms = 1e3 * (time.perf_counter() - t0) / (args.steps - 1)
        summary = dict(ms_per_step=ms, seq_per_s=args.batch / (ms / 1e3))
        print(f"{ms:.1f} ms/step  {summary['seq_per_s']:,.0f} seq/s")
    after = _accuracy(model, eval_pool)
    print(f"eval accuracy: {after:.3f} (before training {before:.3f})")
    return dict(losses=losses, train_accuracy=accs,
                initial_eval_accuracy=before, eval_accuracy=after, **summary)


if __name__ == "__main__":
    main()
