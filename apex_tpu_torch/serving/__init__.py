"""Serving: paged KV cache with the prefix cache, sampling and
speculative acceptance, draft sources, continuous batching (monolithic
or chunked prefill, speculative decoding)."""

from apex_tpu_torch.serving.kv_cache import (
    AdmitResult,
    CacheOutOfPages,
    KVCacheConfig,
    PageAllocator,
    PagedKVCache,
    copy_pages,
    init_pools,
    prompt_page_hashes,
    write_targets,
    write_tokens,
)
from apex_tpu_torch.serving.sampling import (
    greedy,
    sample,
    spec_accept,
    spec_accept_tree,
)
from apex_tpu_torch.serving.serve import (
    Completion,
    ContinuousBatcher,
    Request,
    init_carry,
)
from apex_tpu_torch.serving.speculate import (
    DraftSource,
    ModelDraftSource,
    NGramDraftSource,
    NullDraftSource,
    chain_tree,
    offramp_tree,
    tree_ancestors,
    tree_chain_rows,
    tree_depths,
    tree_max_depth,
    validate_tree,
)

__all__ = [
    "AdmitResult", "CacheOutOfPages", "Completion", "ContinuousBatcher",
    "DraftSource", "KVCacheConfig", "ModelDraftSource", "NGramDraftSource",
    "NullDraftSource", "PageAllocator", "PagedKVCache", "Request",
    "chain_tree", "copy_pages", "greedy", "init_carry", "init_pools",
    "offramp_tree", "prompt_page_hashes", "sample", "spec_accept",
    "spec_accept_tree", "tree_ancestors", "tree_chain_rows", "tree_depths",
    "tree_max_depth", "validate_tree", "write_targets", "write_tokens",
]
