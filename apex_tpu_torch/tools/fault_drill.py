"""Fault drill: SIGKILL a GPT training process mid-``save_async`` and
prove its next life resumes from the last valid checkpoint.

The port's copy of the root ``tools/fault_drill.py`` over the port's
:mod:`apex_tpu_torch.checkpoint` and
:class:`~apex_tpu_torch.utils.autoresume.AutoResume`, with the port's
GPT trainer as the child (on the GPU by default):

1. spawn the child (``--child``): a GPT trainer
   (:class:`~apex_tpu_torch.examples.gpt_pretrain.Trainer`, 2 layers by
   default) that takes one step and checkpoints its whole state (JAX's
   tree) with ``save_async`` after every step, each file write slowed by
   ``--write-delay`` so "mid-save" is a wide target;
2. once ``--kill-after-saves`` checkpoints have landed, SIGKILL the child
   as it announces the next save;
3. check that every surviving ``step_<N>`` directory passes ``verify``
   (checksums intact), and that ``restore_latest_valid`` returns the last
   completed step, whose ``step`` leaves (the loop's and the optimizer's
   counter) name it;
4. re-spawn the child, which must resume from exactly that step and
   finish the run.

Exit code 0 = drill passed::

    python -m apex_tpu_torch.tools.fault_drill --root /tmp/drill
    python -m apex_tpu_torch.tools.fault_drill --root /tmp/drill \\
        --device cpu --trainer-flags "--vocab 256 --hidden 64 --heads 2"
"""

from __future__ import annotations

import argparse
import os
import re
import shlex
import shutil
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the child trainer's flags besides ``--device`` (2 layers)
TRAINER_FLAGS = ("--layers 2 --hidden 256 --heads 2 --vocab 1024 "
                 "--seq 128 --micro-batch 2 --num-micro 1 --pool 1")


def _log(msg: str) -> None:
    print(f"[fault-drill] {msg}", flush=True)


# ------------------------------------------------------------------ child
def run_child(root: str, steps: int, write_delay: float, device: str,
              trainer_flags: str) -> int:
    """Train, checkpointing the whole state after every step with
    ``save_async``, announcing SAVING/SAVED so the parent can time its
    kill."""
    import numpy as np

    from apex_tpu_torch import checkpoint as ckpt
    from apex_tpu_torch.examples import gpt_pretrain
    from apex_tpu_torch.utils.autoresume import AutoResume

    if write_delay > 0:
        # stretch each file write so SIGKILL reliably lands mid-save
        orig_open = ckpt._open

        def slow_open(file, mode="r", *args, **kwargs):
            if any(c in mode for c in "wxa"):
                time.sleep(write_delay)
            return orig_open(file, mode, *args, **kwargs)

        ckpt._open = slow_open

    args = gpt_pretrain.parse_args(
        shlex.split(trainer_flags) + ["--device", device])
    tr = gpt_pretrain.Trainer(args)
    batch = tr.to_device(*gpt_pretrain.batches(
        np.random.default_rng(0), 1, tr.global_batch, args.seq,
        args.vocab)[0])
    ar = AutoResume(root, interval_steps=1, keep=steps + 1)
    state, start = ar.resume(target=tr.state_tree(0))
    if state is not None:
        tr.load_state(state)
    print(f"RESUMED {start}", flush=True)
    for step in range(start + 1, steps + 1):
        tr.step(*batch)
        print(f"SAVING {step}", flush=True)
        handle = ckpt.save_async(os.path.join(root, f"step_{step}"),
                                 tr.state_tree(step))
        handle.result(timeout=300)
        print(f"SAVED {step}", flush=True)
    print("DONE", flush=True)
    return 0


# ----------------------------------------------------------------- parent
def _spawn_child(root: str, steps: int, write_delay: float, device: str,
                 trainer_flags: str):
    env = dict(os.environ, PYTHONPATH=_REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen(
        [sys.executable, "-m", "apex_tpu_torch.tools.fault_drill",
         "--child", "--root", root, "--steps", str(steps),
         "--write-delay", str(write_delay), "--device", device,
         "--trainer-flags", trainer_flags],
        stdout=subprocess.PIPE, text=True, bufsize=1, env=env, cwd=_REPO,
    )


def run_drill(root: str, steps: int, kill_after_saves: int,
              write_delay: float, device: str = "cuda",
              trainer_flags: str = TRAINER_FLAGS) -> int:
    from apex_tpu_torch import checkpoint as ckpt

    if os.path.isdir(root):
        shutil.rmtree(root)
    os.makedirs(root)

    # ---- leg 1: train, then kill -9 mid-save ------------------------
    child = _spawn_child(root, steps, write_delay, device, trainer_flags)
    last_saved = None
    killed_step = None
    try:
        for line in child.stdout:
            line = line.strip()
            if m := re.fullmatch(r"SAVED (\d+)", line):
                last_saved = int(m.group(1))
            elif (m := re.fullmatch(r"SAVING (\d+)", line)) and \
                    last_saved is not None and \
                    last_saved >= kill_after_saves:
                killed_step = int(m.group(1))
                time.sleep(write_delay * 1.5)  # land inside the writes
                _log(f"SIGKILL at save of step {killed_step} "
                     f"(last completed: {last_saved})")
                child.kill()
                break
        else:
            _log("FAIL: child finished before the kill window")
            return 1
    finally:
        if child.poll() is None:
            child.kill()
        child.wait(timeout=60)
        child.stdout.close()

    # ---- verify what the kill left behind ---------------------------
    entries = sorted(os.listdir(root))
    _log(f"post-kill checkpoint root: {entries}")
    complete = [d for d in entries if re.fullmatch(r"step_(\d+)", d)]
    for d in complete:
        bad = ckpt.verify(os.path.join(root, d))
        if bad:
            _log(f"FAIL: surviving checkpoint {d} fails verify: {bad}")
            return 1
    _log(f"all {len(complete)} surviving checkpoints verify clean")

    tree, step = ckpt.restore_latest_valid(root)
    # on a loaded host the SIGKILL can race past the atomic rename: the
    # "interrupted" save may have completed, which is also correct;
    # anything else is not
    if step not in (last_saved, killed_step):
        _log(f"FAIL: restore_latest_valid returned step {step}, "
             f"expected {last_saved} (or {killed_step} if the kill "
             f"lost the race to the rename)")
        return 1
    if step == killed_step:
        _log(f"note: kill landed after step {killed_step}'s rename — "
             f"the save completed; resuming from it is correct")
    if int(tree["step"]) != step or int(tree["opt"]["step"]) != step:
        _log(f"FAIL: restored payload names step {int(tree['step'])} "
             f"(optimizer step {int(tree['opt']['step'])}), not {step}")
        return 1
    _log(f"restore_latest_valid -> step {step} with intact payload")
    resume_from = step

    # ---- leg 2: resurrection must resume from that step -------------
    child = _spawn_child(root, steps, 0.0, device, trainer_flags)
    try:
        out, _ = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != 0:
        _log(f"FAIL: resumed child exited {child.returncode}")
        return 1
    m = re.search(r"^RESUMED (\d+)$", out, re.M)
    if m is None or int(m.group(1)) != resume_from:
        _log(f"FAIL: resumed child reported RESUMED "
             f"{m.group(1) if m else '<none>'}, expected {resume_from}")
        return 1
    if not re.search(r"^DONE$", out, re.M):
        _log("FAIL: resumed child did not finish the run")
        return 1
    _log(f"resumed from step {resume_from} and completed {steps} steps — "
         f"drill PASSED")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.join(
        tempfile.gettempdir(), "apex_tpu_torch_fault_drill"))
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--kill-after-saves", type=int, default=2,
                    help="completed checkpoints required before SIGKILL")
    ap.add_argument("--write-delay", type=float, default=0.05,
                    help="per-file write slowdown in the child (s)")
    ap.add_argument("--device", default="cuda",
                    help="the child trainer's device")
    ap.add_argument("--trainer-flags", default=TRAINER_FLAGS,
                    help="the child trainer's flags besides --device")
    ap.add_argument("--child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.kill_after_saves < 1:
        ap.error("--kill-after-saves must be >= 1")
    if args.child:
        return run_child(args.root, args.steps, args.write_delay,
                         args.device, args.trainer_flags)
    return run_drill(args.root, args.steps, args.kill_after_saves,
                     args.write_delay, args.device, args.trainer_flags)


if __name__ == "__main__":
    sys.exit(main())
