"""apex_tpu_torch.resilience: the fault-tolerance layer.

The port's counterpart of ``apex_tpu/resilience``:

- :mod:`~apex_tpu_torch.resilience.retry`: bounded exponential-backoff
  retry with jitter for transient storage ``OSError``\\ s (the checkpoint
  writes; env-tunable);
- checkpoint integrity lives in :mod:`apex_tpu_torch.checkpoint` itself
  (chunked CRC32 manifests, ``verify``, ``restore_latest_valid``), whose
  :class:`~apex_tpu_torch.checkpoint.CheckpointCorruptError` is
  re-exported here;
- :mod:`~apex_tpu_torch.resilience.guard`: :class:`StepGuard`, the
  divergence monitor (warn, rollback through AutoResume,
  :class:`DivergenceError`);
- :mod:`~apex_tpu_torch.resilience.watchdog`: :class:`Watchdog`, the
  heartbeat stall detector that dumps every thread's stack and can
  abort so the scheduler requeues into autoresume;
- :mod:`~apex_tpu_torch.resilience.faults`: the deterministic fault
  injection (truncation, bit flips, missing files, failing writes and
  renames, SIGTERM mid-save, NaN poisoning, and the fleet's serving
  faults).
"""

from apex_tpu_torch.resilience.retry import RetryPolicy, retry_io
from apex_tpu_torch.resilience.guard import (
    DivergenceError,
    GuardVerdict,
    StepGuard,
    locate_nonfinite,
)
from apex_tpu_torch.resilience.watchdog import (
    Watchdog,
    dump_all_stacks,
    read_heartbeat,
)
from apex_tpu_torch.resilience import faults  # noqa: F401


def __getattr__(name):
    # CheckpointCorruptError lives in apex_tpu_torch.checkpoint (which
    # imports resilience.retry); resolve lazily to avoid the import cycle
    if name == "CheckpointCorruptError":
        from apex_tpu_torch.checkpoint import CheckpointCorruptError

        return CheckpointCorruptError
    raise AttributeError(
        f"module 'apex_tpu_torch.resilience' has no attribute {name!r}")


__all__ = ["RetryPolicy", "retry_io", "StepGuard", "GuardVerdict",
           "DivergenceError", "locate_nonfinite", "Watchdog",
           "dump_all_stacks", "read_heartbeat", "faults",
           "CheckpointCorruptError"]
