"""GPT pretraining: the port's counterpart of ``examples/gpt_pretrain.py``
at pp = dp = 1, on one GPU or tensor-parallel over one process a rank.

    python -m apex_tpu_torch.examples.gpt_pretrain --steps 20
    torchrun --nproc-per-node 2 -m apex_tpu_torch.examples.gpt_pretrain \
        --tp 2 --layers 2 --hidden 64 --heads 2 --vocab 256 --seq 128 \
        --device cpu --steps 3
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

The loop is the JAX trainer's, with its telemetry and resilience:

- ``--data``: batches from a token file of :mod:`apex_tpu_torch.data`
  (``write_token_file``), windows through ``IndexedTokenDataset`` in
  ``MegatronPretrainingSampler`` order (:func:`file_batches`); each batch
  is copied to the card once, from pinned memory;
- the loss stays a device scalar: :class:`~apex_tpu_torch.telemetry.
  metrics.MetricsLogger` resolves the pending losses in one
  device-to-host copy every ``--log-every`` steps (the only host
  synchronisation of the loop besides the first step's and the
  checkpoints'), with live tokens/s and MFU from
  :class:`~apex_tpu_torch.telemetry.metrics.StepStats`;
  ``--metrics-jsonl`` appends the step records and the subsystem events
  (checkpoint saves, verifies and restores, trace windows, guard and
  watchdog events) for ``tools/metrics_report.py``;
- ``--trace-dir`` arms :class:`~apex_tpu_torch.telemetry.spans.
  TraceTrigger`: touch ``<trace-dir>/TRACE_REQUEST`` mid-run (or export
  ``APEX_TPU_TRACE_DIR`` before launch) to capture a ``torch.profiler``
  window of ``APEX_TPU_TRACE_STEPS`` steps;
- ``--watchdog-s``: a :class:`~apex_tpu_torch.resilience.watchdog.
  Watchdog` beaten every step (``$APEX_TPU_HEARTBEAT_FILE`` mirrors it);
- ``--checkpoint-dir``: :class:`~apex_tpu_torch.utils.autoresume.
  AutoResume` with a SIGTERM handler saves every ``--save-every`` steps,
  at a termination request (then the loop returns) and at the last
  step, and a restart resumes after the newest valid step.  The state is
  the JAX trainer's tree, ``{"params", "opt", "amp", "step"}`` in JAX's
  layout (:mod:`apex_tpu_torch.convert`), so a checkpoint written by the
  JAX trainer resumes here and one written here is JAX's bytes.

``--tp N`` shards the model over N ranks (Megatron tensor
parallelism, ``transformer.parallel_state``): a default process group
already initialized is taken as it is, otherwise the trainer initializes
one from ``torchrun``'s environment (NCCL on the card with one rank a
GPU, ``cuda:LOCAL_RANK``; gloo on the CPU), and a node with fewer GPUs
than local ranks raises.  Every rank draws the same batches; the clip is
model-parallel aware and the loss scaler's finite flag reaches consensus
over the tensor-parallel group (``model_parallel_all_finite``), as in the
JAX trainer.  ``--fused-opt-tail`` at tp > 1 raises as JAX's does (its
packed buckets need whole parameters), and so does ``--checkpoint-dir``
(the JAX checkpoint holds the full logical tree; gathering it is a
ROADMAP.md 9a remainder).  A world larger than ``--tp`` is data
parallelism, whose step raises (9b).  The other multi-chip flags of the
JAX trainer raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from apex_tpu_torch import amp, convert
from apex_tpu_torch.amp.policy import check_ported
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.telemetry.metrics import (
    MetricsLogger,
    StepStats,
    device_peak_flops,
    transformer_flops_per_token,
)
from apex_tpu_torch.telemetry.spans import TraceTrigger, phase
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.amp import model_parallel_all_finite
from apex_tpu_torch.transformer.tensor_parallel import clip_grad_norm
from apex_tpu_torch.utils.platform import resolve_device

__all__ = ["Trainer", "batches", "file_batches", "main", "parse_args",
           "run"]

#: flags of the JAX trainer that are not ported: ``dest -> (the value
#: that leaves them off, the ROADMAP.md item that brings them)``
UNPORTED = {
    "pp": (1, "queue A item 9 (pipeline schedules)"),
    "zero": (False, "queue A item 9 (ZeRO)"),
    "zero3": (False, "queue A item 9 (ZeRO-3)"),
    "dp_ici_size": (None, "queue A item 9 (hierarchical data parallelism)"),
    "grad_compression": ("none", "queue A item 9 (quantized collectives)"),
    "compress_ici_legs": (False, "queue A item 9 (quantized collectives)"),
    "no_error_feedback": (False, "queue A item 9 (quantized collectives)"),
    "overlap_grad_sync": (False, "queue A item 9 (overlapped grad sync)"),
    "num_experts": (None, "queue A item 9 (mixture-of-experts)"),
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


def file_batches(path: str, n_batches: int, global_batch: int, seq: int,
                 vocab: int) -> List:
    """A pool from a token file of :mod:`apex_tpu_torch.data`, as the JAX
    trainer draws it: windows through ``IndexedTokenDataset``, order
    through ``MegatronPretrainingSampler`` (one logical rank), at most
    ``n_batches`` ``(tokens, targets)`` int32 pairs on the host."""
    from apex_tpu_torch.data import IndexedTokenDataset, pretraining_batches
    from apex_tpu_torch.transformer.data import MegatronPretrainingSampler

    ds = IndexedTokenDataset(path, seq_len=seq)
    if ds.max_token >= vocab:
        raise ValueError(
            f"{path}: corpus max token id {ds.max_token} >= model vocab "
            f"{vocab} — out-of-range ids would train on clamped/masked "
            f"embeddings silently")
    sampler = MegatronPretrainingSampler(
        total_samples=len(ds), consumed_samples=0,
        micro_batch_size=global_batch,
        data_parallel_rank=0, data_parallel_size=1,
    )
    pool = []
    for toks, tgts in pretraining_batches(ds, sampler):
        pool.append((toks, tgts))
        if len(pool) >= n_batches:
            break
    if not pool:
        raise ValueError(f"{path}: fewer than {global_batch} windows")
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
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree (one process a rank)")
    # the JAX trainer's flags that are not ported (see UNPORTED)
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
    ap.add_argument("--data", default=None,
                    help="token file (apex_tpu_torch.data."
                         "write_token_file); synthetic batches when "
                         "omitted")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save and resume here (AutoResume, SIGTERM-safe)")
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--metrics-jsonl", default=None,
                    help="append step records and subsystem events here "
                         "(tools/metrics_report.py reads it)")
    ap.add_argument("--trace-dir", default=None,
                    help="arm the trace trigger: touch "
                         "<trace-dir>/TRACE_REQUEST mid-run to capture a "
                         "torch.profiler window of APEX_TPU_TRACE_STEPS "
                         "steps")
    ap.add_argument("--watchdog-s", type=float, default=None,
                    help="stall watchdog deadline in seconds")
    return ap.parse_args(argv)


def check_flags(args: argparse.Namespace) -> None:
    """Raise for a flag this slice does not port, or a combination the
    JAX trainer rejects."""
    for dest, (off, item) in UNPORTED.items():
        value = getattr(args, dest)
        if value != off:
            raise NotImplementedError(
                f"--{dest.replace('_', '-')}={value!r} is not ported yet "
                f"(ROADMAP.md {item})")
    if args.tp > 1 and args.fused_opt_tail:
        raise ValueError(
            "--fused-opt-tail needs replicated params: the packed state "
            "buffers concatenate leaves across bucket boundaries and "
            "cannot be sharded over tp — drop the flag or --tp")
    if args.tp > 1 and args.checkpoint_dir:
        raise NotImplementedError(
            f"--checkpoint-dir (--save-every {args.save_every}) at --tp "
            f"{args.tp}: the checkpoint holds the full logical tree and "
            "gathering the shards into it is not ported yet (ROADMAP.md "
            "9a remainder: tp > 1 checkpoints)")


def init_distributed(args: argparse.Namespace) -> None:
    """The process group and the model-parallel grid ``--tp`` needs: a
    default group already initialized is taken as it is; else, for
    ``--tp`` above 1, one from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``): NCCL on the card,
    one rank a GPU (``--device`` becomes ``cuda:LOCAL_RANK``), gloo on the
    CPU.  Then ``initialize_model_parallel(--tp)`` unless a grid exists,
    which must have ``--tp`` ranks on its tensor-parallel axis.  Without
    a group and at ``--tp 1`` nothing is made."""
    import torch.distributed as dist

    if not dist.is_initialized():
        if args.tp == 1:
            return
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                f"--tp {args.tp} needs one process a rank: launch with "
                f"torchrun --nproc-per-node {args.tp} (or initialize "
                "torch.distributed first)")
        on_cpu = args.device is not None and \
            torch.device(args.device).type == "cpu"
        if not on_cpu:
            local = int(os.environ.get("LOCAL_RANK", 0))
            local_world = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
            if torch.cuda.device_count() < local_world:
                raise RuntimeError(
                    f"{local_world} local ranks but "
                    f"{torch.cuda.device_count()} GPUs: NCCL needs one GPU "
                    "a rank")
            args.device = f"cuda:{local}"
            torch.cuda.set_device(args.device)
        dist.init_process_group("gloo" if on_cpu else "nccl")
    if not parallel_state.model_parallel_is_initialized():
        parallel_state.initialize_model_parallel(args.tp)
    tp = parallel_state.get_tensor_model_parallel_world_size()
    if tp != args.tp:
        raise ValueError(
            f"--tp {args.tp} but the model-parallel grid has {tp} "
            "tensor-parallel ranks")


class Trainer:
    """The model, the optimizer, the amp state and one training step,
    built from the trainer's flags.  Parameters are drawn from seed 0.
    ``amp_overrides`` go to ``amp.initialize`` beside ``--opt-level``
    (``loss_scale="dynamic"`` puts the dynamic scaler on O5)."""

    def __init__(self, args: argparse.Namespace,
                 amp_overrides: Optional[Dict] = None):
        check_flags(args)
        init_distributed(args)
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
        # the model's parameters, each sharded one counted whole
        self.n_params = sum(
            p.numel() * (args.tp if getattr(p, "tensor_model_parallel",
                                            False) else 1)
            for p in self.model.parameters())
        self.global_batch = args.micro_batch * args.num_micro
        self.tokens_per_step = self.global_batch * args.seq
        self.flops_per_token = transformer_flops_per_token(
            self.n_params, args.layers, args.hidden, args.seq)

    def to_device(self, tokens: np.ndarray, targets: np.ndarray):
        """A host batch on the trainer's device: on the card one copy
        each, from pinned memory."""
        if self.device.type != "cuda":
            return (torch.as_tensor(tokens, device=self.device),
                    torch.as_tensor(targets, device=self.device))
        return tuple(
            torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(
                self.device, non_blocking=True)
            for a in (tokens, targets))

    # -- the checkpointed state --------------------------------------------
    def state_tree(self, step: int) -> Dict[str, Any]:
        """The JAX trainer's checkpoint tree after ``step``: ``params``
        and ``opt`` in JAX's layout (layers stacked, tensors on the
        device: the checkpoint's snapshot copies them), ``amp`` as JAX's
        ``mp.state_dict`` (float64 scale, int64 counters) and ``step``."""
        self._ensure_opt_state()
        return {
            "params": convert.params_to_jax(self.model.state_dict(),
                                            tensors=True),
            "opt": convert.optimizer_state_to_jax(self.model, self.opt,
                                                  tensors=True),
            "amp": {f"loss_scaler{i}": {
                "loss_scale": s.loss_scale.to(torch.float64),
                "growth_tracker": s.growth_tracker.to(torch.int64),
                "unskipped": s.unskipped.to(torch.int64)}
                for i, s in enumerate(self.amp_state.scaler_states)},
            "step": np.int64(step),
        }

    def load_state(self, state: Dict[str, Any]) -> None:
        """Load a restored :meth:`state_tree` (host tensors or numpy):
        parameters in place, the optimizer's state, the scaler's."""
        self.model.load_state_dict(convert.params_from_jax(state["params"]))
        convert.optimizer_state_from_jax(state["opt"], self.model, self.opt)
        self.amp_state = self.mp.load_state_dict(state["amp"], self.device)

    def _ensure_opt_state(self) -> None:
        """The optimizer's state exists from the start (as JAX's
        ``opt.init``), so a checkpoint or a resume target has it before
        the first step: zeros, the masters copied from the parameters,
        what the first step would make."""
        for p in self.model.parameters():
            self.opt._state(p)
        if self.opt.fused_tail:
            self.opt._ensure_tail()

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
                self.amp_state, grads,
                finite_reduce=model_parallel_all_finite)
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


def run(args: argparse.Namespace,
        step_hook: Optional[Callable[[int, "Trainer"], None]] = None
        ) -> Dict:
    """Train ``args.steps`` steps (after a resumed step, from there);
    returns the losses of the steps this call ran (``start`` is the
    first), the timing of the steps after the first (which builds the
    kernels), the trainer, and ``stopped_at`` where a termination request
    ended the run after its checkpoint.  ``step_hook(i, trainer)`` runs
    after each step's bookkeeping."""
    from apex_tpu_torch.utils.autoresume import AutoResume

    tr = Trainer(args)
    stats = StepStats(tokens_per_step=tr.tokens_per_step,
                      flops_per_token=tr.flops_per_token,
                      peak_flops=device_peak_flops(tr.device))
    tlm = MetricsLogger(jsonl_path=args.metrics_jsonl,
                        flush_every=args.log_every, stats=stats,
                        run="gpt_pretrain")
    # attached before the resume, so its restore events join the stream
    # with the checkpoint, guard and trace events
    tlm.attach_events()
    start = 0
    ar = None
    try:
        if args.checkpoint_dir:
            ar = AutoResume(args.checkpoint_dir,
                            interval_steps=args.save_every,
                            install_sigterm_handler=True)
            restored, start = ar.resume(target=tr.state_tree(0))
            if restored is not None:
                tr.load_state(restored)
                start += 1  # the saved step already ran
                print(f"resuming after step {start - 1}", flush=True)
        return _loop(args, tr, ar, start, step_hook, stats, tlm)
    finally:
        if ar is not None:
            ar.close()
        tlm.close()  # flushes, deregisters the event sink, closes the fd


def _loop(args, tr: Trainer, ar, start: int, step_hook,
          stats: StepStats, tlm: MetricsLogger) -> Dict:
    pool = (file_batches(args.data, args.pool, tr.global_batch, args.seq,
                         args.vocab) if args.data else
            batches(np.random.default_rng(0), args.pool, tr.global_batch,
                    args.seq, args.vocab))
    pool = [tr.to_device(*b) for b in pool]
    print(f"{tr.n_params:,} parameters, {tr.flops_per_token:,} model FLOPs "
          "per token (6·N + 12·L·h·s; N counts every parameter, the SwiGLU "
          "gate included)", flush=True)
    trig = (TraceTrigger(trace_dir=args.trace_dir)
            if (args.trace_dir or os.environ.get("APEX_TPU_TRACE_DIR"))
            else None)
    wd = None
    if args.watchdog_s:
        from apex_tpu_torch.resilience import Watchdog

        wd = Watchdog(deadline_s=args.watchdog_s).start()
    losses: List[torch.Tensor] = []
    loss = None
    out: Dict = {"start": start, "n_params": tr.n_params, "trainer": tr,
                 "logger": tlm}
    try:
        for i in range(start, args.steps):
            with tlm.timing("data"):
                tokens, targets = pool[i % len(pool)]
            loss = tr.step(tokens, targets)
            losses.append(loss)
            if i == start:
                stats.begin(loss)  # one sync: the kernel builds excluded
            else:
                stats.tick()
            tlm.log_scalars(i, loss=loss)  # resolves at the cadence
            if trig is not None:
                trig.poll(i)
            if wd is not None:
                wd.beat(step=i)
            if ar is not None:
                # build the state tree only on ticks maybe_save writes
                due = (i > 0 and i % args.save_every == 0) \
                    or ar.termination_requested() or i == args.steps - 1
                if due:
                    with tlm.timing("checkpoint"), phase("checkpoint"):
                        saved = ar.maybe_save(i, tr.state_tree(i),
                                              force=(i == args.steps - 1))
                    if saved and ar.termination_requested():
                        print("termination requested; checkpoint saved",
                              flush=True)
                        out["stopped_at"] = i
                        break
            if step_hook is not None:
                step_hook(i, tr)
        summary = stats.summary(loss)  # synchronises on the last step
        tlm.flush()
        out["losses"] = (torch.stack(losses).float().cpu().tolist()
                         if losses else [])
        out["ms_per_step"] = summary.get("ms_per_step")
        out["tokens_per_s"] = summary.get("tokens_per_sec")
        out["mfu"] = summary.get("mfu")
        if summary.get("timed_steps") and "stopped_at" not in out:
            line = (f"{summary['ms_per_step']:.1f} ms/step  "
                    f"{summary['tokens_per_sec']:,.0f} tokens/s")
            if "mfu" in summary:
                line += f"  mfu {summary['mfu']:.3f}"
            print(line, flush=True)
        return out
    finally:
        if wd is not None:
            wd.stop()
        if trig is not None:
            trig.close()


def main(argv: Optional[List[str]] = None) -> Dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
