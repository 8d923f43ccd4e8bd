"""Serving: paged KV cache, greedy sampling, continuous batching."""

from apex_tpu_torch.serving.kv_cache import (
    CacheOutOfPages,
    KVCacheConfig,
    PageAllocator,
    PagedKVCache,
    init_pools,
    write_targets,
    write_tokens,
)
from apex_tpu_torch.serving.sampling import greedy, sample
from apex_tpu_torch.serving.serve import (
    Completion,
    ContinuousBatcher,
    Request,
    init_carry,
)

__all__ = [
    "CacheOutOfPages", "Completion", "ContinuousBatcher", "KVCacheConfig",
    "PageAllocator", "PagedKVCache", "Request", "greedy", "init_carry",
    "init_pools", "sample", "write_targets", "write_tokens",
]
