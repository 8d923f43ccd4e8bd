"""Bounded exponential-backoff retry for transient storage I/O.

The port's copy of ``apex_tpu/resilience/retry.py``.  Blob stores and
local disks of preemptible machines fail *transiently* far more often
than they fail permanently; one flaky write must not kill the run.  This
module gives the checkpoint writers a single, env-tunable retry policy:

- bounded attempts (``APEX_TPU_IO_RETRIES`` extra tries, default 3),
- exponential backoff with full jitter (base
  ``APEX_TPU_IO_BACKOFF_BASE`` s, cap ``APEX_TPU_IO_BACKOFF_MAX`` s),
  the standard thundering-herd-safe schedule for many hosts hitting the
  same storage service after a shared blip,
- retries ``OSError`` only — programming errors (TypeError, pickle
  failures) surface immediately.

The policy is re-read from the environment at call time so tests (and
operators mid-run via a debugger) can tune it without re-imports.
"""

from __future__ import annotations

import logging
import os
import random
import time
from typing import Callable, Optional, TypeVar

__all__ = ["RetryPolicy", "retry_io"]

logger = logging.getLogger("apex_tpu_torch.resilience")

T = TypeVar("T")

_ENV_RETRIES = "APEX_TPU_IO_RETRIES"
_ENV_BASE = "APEX_TPU_IO_BACKOFF_BASE"
_ENV_MAX = "APEX_TPU_IO_BACKOFF_MAX"


class RetryPolicy:
    """Immutable description of one retry schedule.

    ``retries`` is the number of *extra* attempts after the first
    (``retries=0`` disables retrying).  Sleep before attempt ``k``
    (1-based retry index) is ``uniform(0, min(max, base * 2**(k-1)))``
    — "full jitter" exponential backoff.
    """

    def __init__(
        self,
        retries: Optional[int] = None,
        backoff_base: Optional[float] = None,
        backoff_max: Optional[float] = None,
        retry_on: tuple = (OSError,),
        rng: Optional[random.Random] = None,
    ):
        if retries is None:
            retries = int(os.environ.get(_ENV_RETRIES, "3"))
        if backoff_base is None:
            backoff_base = float(os.environ.get(_ENV_BASE, "0.05"))
        if backoff_max is None:
            backoff_max = float(os.environ.get(_ENV_MAX, "2.0"))
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        self.retries = retries
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.retry_on = retry_on
        self._rng = rng if rng is not None else random

    def sleep_for(self, attempt: int) -> float:
        """Jittered backoff before retry ``attempt`` (1-based)."""
        cap = min(self.backoff_max, self.backoff_base * (2.0 ** (attempt - 1)))
        return self._rng.uniform(0.0, cap)

    def call(self, fn: Callable[[], T], describe: str = "") -> T:
        """Run ``fn`` retrying transient failures per this policy.

        Raises the last failure once attempts are exhausted, with
        ``__notes__``-free chaining (earlier failures are logged, the
        final exception propagates unchanged so callers can match on
        errno/type).
        """
        last: Optional[BaseException] = None
        for attempt in range(self.retries + 1):
            try:
                return fn()
            except self.retry_on as e:  # transient: back off and retry
                last = e
                if attempt == self.retries:
                    break
                delay = self.sleep_for(attempt + 1)
                logger.warning(
                    "transient I/O failure%s (attempt %d/%d): %r; "
                    "retrying in %.3fs",
                    f" during {describe}" if describe else "",
                    attempt + 1, self.retries + 1, e, delay,
                )
                time.sleep(delay)
        assert last is not None
        raise last


def retry_io(fn: Callable[[], T], describe: str = "",
             policy: Optional[RetryPolicy] = None) -> T:
    """Run ``fn()`` under the env-configured (or given) retry policy."""
    return (policy if policy is not None else RetryPolicy()).call(
        fn, describe
    )
