"""Run a function in spawned ranks of a process group: the harness of the
tensor-parallel checks, on the CPU (gloo) and on one card.

    results = spawn(fn, 2, args=(...,), workdir=d)

starts ``world_size`` processes (``torch.multiprocessing``, spawn, one
CPU thread each), each of which joins a gloo process group through a
``file://`` rendezvous in ``workdir`` (no TCP port, so concurrent test
workers cannot collide), lays the ranks out as one tensor-parallel group
(``parallel_state.initialize_model_parallel(world_size)``) and returns
``fn(rank, *args)``, which is saved with ``torch.save`` and
read back here: one result a rank, in rank order.  A rank that raises
fails the call with its traceback; a rank that hangs past ``timeout_s``
(the rendezvous, every collective and the join are bounded by it) fails
it too, after every process it started is killed.  Gloo, because two
ranks on one GPU cannot use NCCL, which refuses two ranks on one device.
"""

from __future__ import annotations

import datetime
import os
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch

__all__ = ["spawn"]


def _rank_main(rank: int, fn: Callable, world_size: int, args: Sequence,
               workdir: str, timeout_s: float) -> None:
    import torch.distributed as dist

    from apex_tpu_torch.transformer import parallel_state

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(workdir, "rdv"),
            rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
        parallel_state.initialize_model_parallel(world_size)
        out = fn(rank, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        parallel_state.destroy_model_parallel()
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, args: Sequence = (), *,
          workdir: str, timeout_s: float = 300.0) -> List[Any]:
    """``fn(rank, *args)`` on each of ``world_size`` spawned
    tensor-parallel ranks; returns the ranks' results.  ``fn`` must be
    importable by the spawned processes (a module-level function)."""
    import torch.multiprocessing as mp

    os.makedirs(workdir, exist_ok=True)
    for name in os.listdir(workdir):
        if name == "rdv" or name.startswith("rank"):
            os.remove(os.path.join(workdir, name))
    ctx = mp.start_processes(
        _rank_main, args=(fn, world_size, tuple(args), workdir,
                          timeout_s),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{world_size} ranks of {getattr(fn, '__name__', fn)} "
                    f"still running after {timeout_s:.0f} s")
    except Exception as err:
        errors = [open(os.path.join(workdir, n)).read()
                  for n in sorted(os.listdir(workdir)) if n.endswith(".err")]
        raise RuntimeError("a rank failed:\n" + "\n".join(errors)) from err
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world_size)]
