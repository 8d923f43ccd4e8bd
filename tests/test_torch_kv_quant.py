"""Int8 KV pages in the port against the JAX package.

- ``write_tokens(quantized=True)`` stores the same int8 values and fp32
  scales as JAX's, bit for bit (both go through ``quantize_rows``), and
  rejects a flag that disagrees with the pools;
- ``fmha_decode`` over int8 pages (the CUDA kernel's plain version on
  CPU tensors) matches ``_decode_kernel``'s ``has_scales`` branch in
  interpret mode: fp32 on both sides, 1e-5 absolute and relative (sums in
  another order); its validation raises JAX's errors;
- the tiny GPT serving from int8 pages (fp32 and int4 weights) gives JAX's
  greedy tokens, token for token, under 6-request / 2-slot churn.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.attention_decode import fmha_decode as jax_fmha_decode
from apex_tpu.serving import kv_cache as jax_kv
from apex_tpu_torch.ops import attention_decode as port_decode
from apex_tpu_torch.serving import KVCacheConfig, init_pools, write_tokens

import test_torch_weight_quant as wq

TOL = dict(rtol=1e-5, atol=1e-5)
H, D, PAGE, PPS = 4, 32, 16, 9

# the module-scoped mesh with JAX's shard_map vma check off
mesh = wq.mesh


def test_config_takes_int8_only():
    cfg = KVCacheConfig(num_layers=2, num_heads=H, head_dim=D, num_pages=8,
                        kv_dtype=torch.int8, kv_block=8)
    assert cfg.quantized and cfg.scale_blocks == 4
    assert not KVCacheConfig(num_layers=2, num_heads=H, head_dim=D,
                             num_pages=8).quantized
    with pytest.raises(ValueError, match="kv_dtype must be None or int8"):
        KVCacheConfig(num_layers=2, num_heads=H, head_dim=D, num_pages=8,
                      kv_dtype=torch.float16)


@pytest.mark.parametrize("kv_block", [128, 8])
def test_init_pools_match_jax(kv_block):
    kw = dict(num_layers=2, num_heads=H, head_dim=D, num_pages=5,
              page_size=PAGE, max_seqs=2, pages_per_seq=2,
              kv_block=kv_block)
    got = init_pools(KVCacheConfig(**kw, dtype=torch.float32,
                                   kv_dtype=torch.int8), "cpu")
    want = jax_kv.init_pools(jax_kv.KVCacheConfig(
        **kw, dtype=jnp.float32, kv_dtype=jnp.int8))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
        assert got[name].numpy().dtype == np.asarray(want[name]).dtype


@pytest.mark.parametrize("kv_block", [128, 8, 12])
def test_quantized_writes_bit_identical_to_jax(kv_block):
    cfg = dict(num_layers=1, num_heads=H, head_dim=D, num_pages=6,
               page_size=PAGE, max_seqs=2, pages_per_seq=3,
               kv_block=kv_block)
    rng = np.random.RandomState(kv_block)
    k_new = (3.0 * rng.randn(5, H, D)).astype(np.float32)
    v_new = rng.randn(5, H, D).astype(np.float32)
    v_new[1, 2] = 0.0                                  # an all-zero row
    pages = np.array([1, 1, 4, 0, 5], np.int32)
    offs = np.array([0, 3, 15, 0, 7], np.int32)
    jp = jax_kv.init_pools(jax_kv.KVCacheConfig(
        **cfg, dtype=jnp.float32, kv_dtype=jnp.int8))
    jl = {name: pool[0] for name, pool in jp.items()}
    want = jax_kv.write_tokens(jl, jnp.asarray(k_new), jnp.asarray(v_new),
                               jnp.asarray(pages), jnp.asarray(offs),
                               quantized=True, kv_block=kv_block)
    tp = init_pools(KVCacheConfig(**cfg, dtype=torch.float32,
                                  kv_dtype=torch.int8), "cpu")
    tl = {name: pool[0] for name, pool in tp.items()}
    write_tokens(tl, torch.from_numpy(k_new), torch.from_numpy(v_new),
                 torch.from_numpy(pages).long(),
                 torch.from_numpy(offs).long(), quantized=True,
                 kv_block=kv_block)
    live = pages != 0        # the null page takes the idle entry's garbage
    for name in ("k", "v", "k_scales", "v_scales"):
        g = tp[name][0].numpy()[pages[live], :, offs[live]]
        w = np.asarray(want[name])[pages[live], :, offs[live]]
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.view(np.int32) if g.dtype ==
                                      np.float32 else g,
                                      w.view(np.int32) if w.dtype ==
                                      np.float32 else w)
    # in place: the full pools' layer 0 holds the writes
    assert tp["k"][0, 1, :, 3].abs().sum() > 0


def test_quantized_flag_must_match_the_pools():
    kw = dict(num_layers=1, num_heads=H, head_dim=D, num_pages=4,
              page_size=PAGE, max_seqs=1, pages_per_seq=2,
              dtype=torch.float32)
    rows = torch.zeros(1, H, D)
    at = torch.ones(1, dtype=torch.long)
    plain = {n: p[0] for n, p in init_pools(KVCacheConfig(**kw),
                                            "cpu").items()}
    with pytest.raises(ValueError, match="quantized=True"):
        write_tokens(plain, rows, rows, at, at, quantized=True)
    q8 = {n: p[0] for n, p in init_pools(KVCacheConfig(
        **kw, kv_dtype=torch.int8), "cpu").items()}
    with pytest.raises(ValueError, match="quantized=False"):
        write_tokens(q8, rows, rows, at, at)


def _layout(sq, kv_block, seed):
    """4 slots (idle, partial page, page boundary, ragged tail), int8
    pages and their scales drawn as the cache's quantizer makes them."""
    rng = np.random.RandomState(seed)
    lengths = np.array([0, max(sq, 5), 2 * PAGE, 4 * PAGE + 7], np.int32)
    num_pages = 1 + int(sum(-(-n // PAGE) for n in lengths))
    perm = rng.permutation(np.arange(1, num_pages))
    table = np.zeros((4, PPS), np.int32)
    at = 0
    for b, n in enumerate(lengths):
        used = -(-int(n) // PAGE)
        table[b, :used] = perm[at:at + used]
        at += used
    nb = -(-D // kv_block)
    kv = [rng.randint(-127, 128, (num_pages, H, PAGE, D)).astype(np.int8)
          for _ in range(2)]
    scales = [(rng.rand(num_pages, H, PAGE, nb) / 40).astype(np.float32)
              for _ in range(2)]
    q = rng.randn(4, H, sq, D).astype(np.float32)
    return q, kv, scales, table, lengths


@pytest.mark.parametrize("sq", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_block", [128, 8])
def test_int8_pages_match_pallas(sq, causal, kv_block):
    q, (k, v), (ks, vs), table, lengths = _layout(sq, kv_block,
                                                  seed=sq + kv_block)
    want = jax_fmha_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(lengths), causal=causal, k_scales=jnp.asarray(ks),
        v_scales=jnp.asarray(vs), kv_block=kv_block,
        implementation="pallas")
    got = port_decode.fmha_decode(
        *(torch.from_numpy(a) for a in (q, k, v, table, lengths)),
        causal=causal, k_scales=torch.from_numpy(ks),
        v_scales=torch.from_numpy(vs), kv_block=kv_block)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_int8_pages_with_fused_rope_match_pallas():
    sq = 2
    q, (k, v), (ks, vs), table, lengths = _layout(sq, 128, seed=9)
    pos = lengths[:, None] - sq + np.arange(sq)[None]
    ang = np.clip(pos, 0, None)[..., None] * (
        10000.0 ** (-np.arange(D // 2) / (D // 2)))[None, None]
    cos, sin = (f(ang).astype(np.float32) for f in (np.cos, np.sin))
    want = jax_fmha_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(lengths), k_scales=jnp.asarray(ks),
        v_scales=jnp.asarray(vs), rope=(jnp.asarray(cos), jnp.asarray(sin)),
        implementation="pallas")
    got = port_decode.fmha_decode(
        *(torch.from_numpy(a) for a in (q, k, v, table, lengths)),
        k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs),
        rope=(torch.from_numpy(cos), torch.from_numpy(sin)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", ["one_scale", "no_scales",
                                  "scales_on_float"])
def test_validation_errors_match_jax(case):
    q, (k, v), (ks, vs), table, lengths = _layout(1, 128, seed=4)
    out = []
    for fn, arr in ((jax_fmha_decode, jnp.asarray),
                    (port_decode.fmha_decode, torch.from_numpy)):
        pages = (arr(k), arr(v))
        kw = dict(k_scales=arr(ks), v_scales=arr(vs))
        if case == "one_scale":
            kw.pop("v_scales")
        elif case == "no_scales":
            kw = {}
        else:
            pages = (arr(k.astype(np.float32)), arr(v.astype(np.float32)))
        with pytest.raises(ValueError) as e:
            fn(arr(q), *pages, arr(table), arr(lengths), **kw)
        out.append(str(e.value).replace("torch.", ""))
    assert out[1] == out[0]


@pytest.mark.parametrize("weight_dtype", [None, "int4"])
def test_int8_kv_greedy_tokens_match_jax(mesh, weight_dtype):
    jm, tm, params = wq.models("flagship")
    want, _ = wq.jax_tokens(mesh, jm, params, weight_dtype,
                            kv_dtype=jnp.int8)
    assert len({tuple(t) for t in want}) >= 5
    got, _ = wq.port_tokens(tm, weight_dtype, kv_dtype=torch.int8)
    assert got == want
