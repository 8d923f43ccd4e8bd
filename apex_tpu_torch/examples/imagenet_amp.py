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

``--checkpoint-dir`` saves the JAX example's state tree after every
epoch (``step_<epoch>``, and ``best.ckpt`` on a new best prec@1) through
:mod:`apex_tpu_torch.checkpoint`: ``params`` and ``bn_stats`` in the JAX
ResNet's layout, ``opt_state`` (``step``, ``momentum_buffer``,
``master``), ``epoch`` and ``best_prec1``; ``--resume`` restores the
newest step and continues after its epoch.  ``--metrics-jsonl`` appends
the step losses (resolved once an epoch) and the checkpoint events.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch import checkpoint
from apex_tpu_torch.models.resnet import ResNet, ResNetConfig
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.telemetry.metrics import MetricsLogger
from apex_tpu_torch.utils.platform import resolve_device

__all__ = ["main", "parse_args", "synthetic_pool", "train_step",
           "eval_step", "validate", "state_tree", "load_state"]


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
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save per-epoch checkpoints + best.ckpt here")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint from "
                         "--checkpoint-dir before training")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="append step losses + checkpoint events here")
    return ap.parse_args(argv)


def _map(tree: Any, fn: Callable) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


@torch.no_grad()
def _copy(dst: Any, src: Any) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _copy(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _copy(d, s)
    else:
        dst.copy_(src)


def _opt_state(model: ResNet, opt) -> Dict[str, Any]:
    """The optimizer's state as the JAX ``FusedSGD`` tree over the
    model's ``params`` tree (the same tensors); made on first use, as
    JAX's ``opt.init``."""
    for p in model.parameters():
        opt._state(p)
    first = opt.state[next(model.parameters())]
    out: Dict[str, Any] = {"step": first["step"]}
    for key in ("momentum_buffer", "master"):
        if key in first:
            out[key] = _map(model.params_tree(),
                            lambda p, key=key: opt.state[p][key])
    return out


def state_tree(model: ResNet, opt, epoch: int,
               best_prec1: float) -> Dict[str, Any]:
    """The JAX example's checkpoint tree (the live tensors: the
    checkpoint's snapshot copies them)."""
    return {"params": model.params_tree(), "opt_state": _opt_state(model, opt),
            "bn_stats": model.stats_tree(), "epoch": np.int64(epoch),
            "best_prec1": np.float64(best_prec1)}


def load_state(model: ResNet, opt, state: Dict[str, Any]) -> tuple:
    """Copy a restored :func:`state_tree` into the model and optimizer;
    returns ``(epoch, best_prec1)``."""
    _copy(state_tree(model, opt, 0, 0.0)["params"], state["params"])
    _copy(_opt_state(model, opt), state["opt_state"])
    model.load_stats(state["bn_stats"])
    return int(state["epoch"]), float(state["best_prec1"])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume needs --checkpoint-dir")
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
    start_epoch, best_prec1 = 0, 0.0
    if args.resume:
        last = checkpoint.latest_step(args.checkpoint_dir)
        if last is None:
            print(f"no checkpoint under {args.checkpoint_dir}; "
                  "starting fresh")
        else:
            state = checkpoint.restore_step(
                args.checkpoint_dir, step=last,
                target=state_tree(model, opt, 0, 0.0))
            epoch, best_prec1 = load_state(model, opt, state)
            start_epoch = epoch + 1
            print(f"resumed epoch {epoch} (best prec@1 {best_prec1:.2f}) "
                  f"from {args.checkpoint_dir}")
    if args.evaluate:
        loss, p1, p5 = validate(model, val_pool)
        print(f"eval: loss {loss:.3f}  prec@1 {p1:.2f}  prec@5 {p5:.2f}")
        return {"model": model, "prec1": p1, "prec5": p5}
    # step losses stay device scalars until the epoch's one flush
    with MetricsLogger(jsonl_path=args.metrics_jsonl, console=False,
                       flush_every=max(args.steps_per_epoch, 1),
                       run="imagenet_amp").attach_events() as tlm:
        return _train_epochs(args, model, opt, device, train_pool, val_pool,
                             start_epoch, best_prec1, tlm)


def _train_epochs(args, model, opt, device, train_pool, val_pool,
                  start_epoch: int, best_prec1: float, tlm) -> Dict:
    out: Dict = {}
    for epoch in range(start_epoch, args.epochs):
        held, t0 = [], None
        for i in range(args.steps_per_epoch):
            held.append(train_step(model, opt,
                                   *train_pool[i % len(train_pool)]))
            tlm.log_scalars(epoch * args.steps_per_epoch + i,
                            loss=held[-1][0])
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
        if args.checkpoint_dir:
            state = state_tree(model, opt, epoch, best_prec1)
            path = checkpoint.save_step(args.checkpoint_dir, epoch, state)
            if is_best:
                checkpoint.save(
                    os.path.join(args.checkpoint_dir, "best.ckpt"), state)
            print(f"  saved {path}" + ("  (best)" if is_best else ""),
                  flush=True)
    return dict(out, model=model, best_prec1=best_prec1,
                start_epoch=start_epoch)


if __name__ == "__main__":
    main()
