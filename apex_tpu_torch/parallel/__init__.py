"""The data-parallel runtime's counterparts: so far ``SyncBatchNorm``
(one replica; the rest of ``apex_tpu.parallel`` is ROADMAP.md queue A
item 9)."""

from apex_tpu_torch.parallel.sync_batchnorm import (
    SyncBatchNorm,
    sync_batch_norm,
)

__all__ = ["SyncBatchNorm", "sync_batch_norm"]
