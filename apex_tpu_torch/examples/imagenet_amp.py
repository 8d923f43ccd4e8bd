"""ImageNet-style ResNet training on one GPU: the port's counterpart of
``examples/imagenet_amp.py``.

    python -m apex_tpu_torch.examples.imagenet_amp --depth 50 \\
        --batch-size 32 --epochs 1 --steps-per-epoch 20
    python -m apex_tpu_torch.examples.imagenet_amp --depth 18 \\
        --batch-size 4 --image-size 32 --num-classes 10 \\
        --steps-per-epoch 2 --eval-steps 1 --device cpu

The JAX example's step at one replica: the default ``ResNetConfig`` (fp32
parameters, bf16 compute, fp32 batch-norm statistics), the mean
cross entropy of ``log_softmax(logits)`` against one-hot labels, its
backward, and ``FusedSGD(momentum=0.9, weight_decay=1e-4,
master_weights=True)``; each epoch prints the running loss, prec@1 and
prec@5 and images/s (the steps after the epoch's first), then
``validate`` scores a fixed set in eval mode (the running statistics).
The data is the JAX example's synthetic pool, drawn from the same numpy
seeds: ``min(steps, 8)`` training batches cycled and ``--eval-steps``
validation batches.  ``--evaluate`` runs validation only.  ``--device``
defaults to the GPU and raises without one.

Flags of the JAX example that the port does not have yet
(``--checkpoint-dir``, ``--resume``, ``--metrics-jsonl``) raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch.models.resnet import ResNet, ResNetConfig
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.utils.platform import resolve_device

__all__ = ["UNPORTED", "main", "parse_args", "synthetic_pool", "train_step",
           "eval_step", "validate"]

#: flags of the JAX example that are not ported: ``dest -> (the value
#: that leaves them off, the ROADMAP.md item that brings them)``
UNPORTED = {
    "checkpoint_dir": (None, "queue A item 10 (checkpointing)"),
    "resume": (False, "queue A item 10 (checkpointing)"),
    "metrics_jsonl": (None, "queue A item 10 (telemetry)"),
}


def synthetic_pool(seed: int, n_batches: int, global_batch: int,
                   image_size: int, num_classes: int, device) -> List:
    """The JAX example's deterministic synthetic data: ``n_batches``
    ``(images (B, H, W, 3) fp32 NHWC, labels (B,) int64)`` pairs from a
    numpy seed, drawn once (host RNG stays out of the timed loop)."""
    rng = np.random.default_rng(seed)
    pool = []
    for _ in range(n_batches):
        images = rng.normal(size=(global_batch, image_size, image_size,
                                  3)).astype(np.float32)
        labels = rng.integers(0, num_classes, (global_batch,))
        pool.append((torch.as_tensor(images, device=device),
                     torch.as_tensor(labels, dtype=torch.int64,
                                     device=device)))
    return pool


def _topk_correct(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``(#top-1 correct, #top-5 correct, #examples)`` as an fp32 device
    vector (the reference's ``accuracy(output, target, topk=(1, 5))``)."""
    hit = logits.topk(min(5, logits.shape[-1]), dim=-1).indices \
        == labels[:, None]
    return torch.stack([hit[:, 0].float().sum(), hit.any(dim=1).float().sum(),
                        torch.tensor(float(labels.shape[0]),
                                     device=logits.device)])


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    one_hot = F.one_hot(labels, logits.shape[-1]).float()
    return -torch.mean(torch.sum(F.log_softmax(logits, dim=-1) * one_hot,
                                 dim=-1))


def train_step(model: ResNet, opt, images, labels):
    """One step: forward in training mode (the buffers take the new
    running statistics), backward, SGD.  Returns ``(loss, meters)`` as
    device tensors."""
    opt.zero_grad(set_to_none=True)
    logits = model(images, training=True)
    loss = _xent(logits, labels)
    loss.backward()
    opt.step()
    return loss.detach(), _topk_correct(logits.detach(), labels)


@torch.no_grad()
def eval_step(model: ResNet, images, labels):
    """Eval mode (the running statistics): ``(loss, meters)``."""
    logits, _ = model.apply(None, None, images, training=False)
    return _xent(logits, labels), _topk_correct(logits, labels)


def validate(model: ResNet, val_pool) -> tuple:
    """A pass over the fixed validation set: ``(mean loss, prec@1,
    prec@5)``, the precisions in percent."""
    results = [eval_step(model, *batch) for batch in val_pool]
    losses = [float(l) for l, _ in results]
    c1, c5, n = torch.stack([m for _, m in results]).sum(0).tolist()
    return float(np.mean(losses)), 100.0 * c1 / n, 100.0 * c5 / n


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depth", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=32,
                    help="per-device batch")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--steps-per-epoch", type=int, default=20)
    ap.add_argument("--eval-steps", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--evaluate", action="store_true",
                    help="validation only")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs on the CPU")
    # the JAX example's flags that are not ported (see UNPORTED)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--metrics-jsonl", default=None)
    return ap.parse_args(argv)


def check_flags(args: argparse.Namespace) -> None:
    """Raise for a flag the port does not have yet."""
    for dest, (off, item) in UNPORTED.items():
        value = getattr(args, dest)
        if value != off:
            raise NotImplementedError(
                f"--{dest.replace('_', '-')}={value!r} is not ported yet "
                f"(ROADMAP.md {item})")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    check_flags(args)
    device = resolve_device(args.device)
    model = ResNet(ResNetConfig(depth=args.depth,
                                num_classes=args.num_classes),
                   device=device, seed=0)
    opt = FusedSGD(model.parameters(), lr=args.lr, momentum=0.9,
                   weight_decay=1e-4, master_weights=True)
    train_pool = synthetic_pool(0, min(args.steps_per_epoch, 8),
                                args.batch_size, args.image_size,
                                args.num_classes, device)
    val_pool = synthetic_pool(1, args.eval_steps, args.batch_size,
                              args.image_size, args.num_classes, device)
    if args.evaluate:
        loss, p1, p5 = validate(model, val_pool)
        print(f"eval: loss {loss:.3f}  prec@1 {p1:.2f}  prec@5 {p5:.2f}")
        return {"model": model, "prec1": p1, "prec5": p5}
    best_prec1, out = 0.0, {}
    for epoch in range(args.epochs):
        held, t0 = [], None
        for i in range(args.steps_per_epoch):
            held.append(train_step(model, opt,
                                   *train_pool[i % len(train_pool)]))
            if i == 0:
                _sync(device)
                t0 = time.perf_counter()
        _sync(device)
        timed = args.steps_per_epoch - 1
        ips = (args.batch_size * timed / (time.perf_counter() - t0)
               if timed else float("nan"))
        losses = [float(l) for l, _ in held]
        c1, c5, n = torch.stack([m for _, m in held]).sum(0).tolist()
        print(f"epoch {epoch}: loss {np.mean(losses):.3f}  prec@1 "
              f"{100 * c1 / n:.2f}  prec@5 {100 * c5 / n:.2f}  "
              f"{ips:,.1f} img/s", flush=True)
        val_loss, p1, p5 = validate(model, val_pool)
        is_best = p1 > best_prec1
        best_prec1 = max(best_prec1, p1)
        print(f"  val: loss {val_loss:.3f}  prec@1 {p1:.2f}  prec@5 "
              f"{p5:.2f}  best {best_prec1:.2f}{'  *' if is_best else ''}",
              flush=True)
        out = dict(losses=losses, prec1=p1, prec5=p5, val_loss=val_loss,
                   images_per_s=ips)
    return dict(out, model=model, best_prec1=best_prec1)


if __name__ == "__main__":
    main()
