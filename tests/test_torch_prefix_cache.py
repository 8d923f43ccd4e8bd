"""The port's prefix cache against the JAX package's, step by step.

The same admit / register / retire sequence drives
``apex_tpu.serving.kv_cache.PagedKVCache`` and the port's
``apex_tpu_torch.serving.kv_cache.PagedKVCache`` (host code on both
sides): after every step the page tables, lengths, refcounts, free
lists, shared-page counts, prefix-index sizes, ``AdmitResult`` fields
and the prompt hashes (as bytes) must be equal.  The sequence includes a
partial match, a whole-prompt match (the copy-on-write tail), retirement
of a sharer, and a page-starved admission that evicts index-only pages.
``copy_pages`` must equal the JAX function on the same pools; the
exact-equality gates are bit-for-bit (these are integers, bytes and
copies).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.serving import kv_cache as jkv
from apex_tpu_torch.serving import kv_cache as tkv

torch.set_num_threads(1)  # the suite's parallel workers share the cores

PAGE = 4


def _pair(num_pages=12, max_seqs=3, pps=4, kv_dtype=None):
    jcfg = jkv.KVCacheConfig(num_layers=2, num_heads=2, head_dim=8,
                             num_pages=num_pages, page_size=PAGE,
                             max_seqs=max_seqs, pages_per_seq=pps,
                             dtype=jnp.float32,
                             kv_dtype=None if kv_dtype is None
                             else jnp.int8)
    tcfg = tkv.KVCacheConfig(num_layers=2, num_heads=2, head_dim=8,
                             num_pages=num_pages, page_size=PAGE,
                             max_seqs=max_seqs, pages_per_seq=pps,
                             dtype=torch.float32, kv_dtype=kv_dtype)
    return jkv.PagedKVCache(jcfg), tkv.PagedKVCache(tcfg)


def _same_state(j, t):
    np.testing.assert_array_equal(j.page_table, t.page_table)
    np.testing.assert_array_equal(j.lengths, t.lengths)
    assert j.allocator._refcount == t.allocator._refcount
    assert j.allocator._free == t.allocator._free
    assert j.allocator.num_shared == t.allocator.num_shared
    assert j.prefix_index_size == t.prefix_index_size
    assert j._prefix == t._prefix
    assert j._extra_refs == t._extra_refs
    assert j.active_slots() == t.active_slots()


def _admit(j, t, slot, total, prompt):
    rj = j.admit(slot, total, prompt_tokens=prompt)
    rt = t.admit(slot, total, prompt_tokens=prompt)
    assert dataclasses.asdict(rj) == dataclasses.asdict(rt)
    _same_state(j, t)
    return rt


def test_hashes_are_byte_identical():
    rng = np.random.RandomState(0)
    for n in (3, 4, 9, 17):
        prompt = rng.randint(0, 50000, n).tolist()
        for page in (1, 4, 16):
            assert (tkv.prompt_page_hashes(prompt, page)
                    == jkv.prompt_page_hashes(prompt, page))


def test_admit_register_retire_evict_sequence_matches_jax():
    j, t = _pair(num_pages=10)
    a = list(range(1, 11))                   # 10 tokens: 2 full pages
    b = a[:8] + [40, 41, 42]                 # shares a's 2 full pages
    c = a[:8]                                # whole-prompt match: CoW
    # a cold admission, registered after its prefill
    res = _admit(j, t, 0, 14, a)
    assert res.matched_tokens == 0 and res.shared_pages == 0
    assert (j.register_prefix(0, a, hashes=res.page_hashes)
            == t.register_prefix(0, a, hashes=res.page_hashes) == 2)
    _same_state(j, t)
    # a partial match shares both full pages
    res = _admit(j, t, 1, 13, b)
    assert res.matched_tokens == 8 and res.shared_pages == 2
    assert t.allocator.num_shared == 2
    assert j.match_len(res.page_hashes) == t.match_len(res.page_hashes)
    # a whole-prompt match: the last page is copied, not shared
    res = _admit(j, t, 2, 10, c)
    assert res.matched_tokens == 7 and res.copied_page is not None
    # retire a sharer: its references drop, the index keeps the pages
    j.retire(1)
    t.retire(1)
    _same_state(j, t)
    j.retire(0)
    t.retire(0)
    _same_state(j, t)
    # a page-starved admission evicts index-only pages (refcount GC)
    j.retire(2)
    t.retire(2)
    _same_state(j, t)
    assert t.prefix_index_size == 2 and t.allocator.num_free == 7
    _admit(j, t, 0, 4 * PAGE, [99] * 16)
    _admit(j, t, 1, 4 * PAGE, [98] * 16)     # one page short: evicts
    assert t.prefix_index_size == 1 and t.allocator.num_free == 0
    with pytest.raises(jkv.CacheOutOfPages):
        j.admit(2, 4 * PAGE, prompt_tokens=[97] * 16)
    with pytest.raises(tkv.CacheOutOfPages):
        t.admit(2, 4 * PAGE, prompt_tokens=[97] * 16)
    _same_state(j, t)
    assert j.compat_key() == t.compat_key()


def test_eviction_frees_leaves_first_and_protects_matches():
    """Fill the index with two chains, then admit while short of pages:
    both packages evict the same leaves, keeping what the admission
    matched."""
    j, t = _pair(num_pages=9, max_seqs=2, pps=4)
    p1, p2 = list(range(1, 13)), list(range(20, 32))
    for prompt in (p1, p2):
        res = _admit(j, t, 0, 12, prompt)
        j.register_prefix(0, prompt, hashes=res.page_hashes)
        t.register_prefix(0, prompt, hashes=res.page_hashes)
        j.retire(0)
        t.retire(0)
        _same_state(j, t)
    assert t.prefix_index_size == 6
    res = _admit(j, t, 1, 16, p1[:4] + [5] * 6)    # 3 fresh, 2 free
    assert res.shared_pages == 1 and t.prefix_index_size == 5
    assert res.page_hashes[0] in t._prefix
    assert (j._evict_prefix(10) == t._evict_prefix(10))
    _same_state(j, t)


def test_adopt_prefix_page_and_allocator_share_match_jax():
    j, t = _pair()
    h = tkv.prompt_page_hashes(list(range(8)), PAGE)
    assert j.adopt_prefix_page(h[0], None) == t.adopt_prefix_page(h[0], None)
    assert j.adopt_prefix_page(h[1], h[0]) == t.adopt_prefix_page(h[1], h[0])
    _same_state(j, t)
    for cache in (j, t):
        with pytest.raises(ValueError, match="already indexed"):
            cache.adopt_prefix_page(h[0], None)
        with pytest.raises(ValueError, match="cannot share"):
            cache.allocator.share([11])
    assert t.evict_hook is None and t.evict_batch == j.evict_batch


@pytest.mark.parametrize("kv_dtype", [None, torch.int8])
def test_copy_pages_matches_jax(kv_dtype):
    rng = np.random.RandomState(1)
    _, t = _pair(kv_dtype=kv_dtype)
    pools = tkv.init_pools(t.config, "cpu")
    arrays = {}
    for name, p in pools.items():
        if p.dtype == torch.int8:
            a = rng.randint(-127, 128, p.shape).astype(np.int8)
        else:
            a = rng.randn(*p.shape).astype(np.float32)
        arrays[name] = a
        p.copy_(torch.from_numpy(a))
    src, dst = np.array([3, 5], np.int32), np.array([7, 2], np.int32)
    want = jkv.copy_pages({k: jnp.asarray(v) for k, v in arrays.items()},
                          src, dst)
    got = tkv.copy_pages(pools, torch.from_numpy(src), torch.from_numpy(dst))
    assert got is pools
    for name in arrays:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
