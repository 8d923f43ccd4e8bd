"""The port's pretraining data (``apex_tpu_torch.data``,
``apex_tpu_torch.transformer.data`` and the trainer's ``file_batches``)
against the JAX package's, on the CPU: the same token file gives the same
windows, the samplers the same index batches for every rank, and the
trainer's pool the JAX trainer's batches."""

import importlib.util
import json
import os

import numpy as np
import pytest

from apex_tpu import data as jdata
from apex_tpu.transformer import data as jtdata
from apex_tpu_torch import data as tdata
from apex_tpu_torch.examples import gpt_pretrain
from apex_tpu_torch.transformer import data as ttdata

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_trainer():
    """The JAX trainer module (``examples/gpt_pretrain.py``)."""
    spec = importlib.util.spec_from_file_location(
        "jax_gpt_pretrain", os.path.join(REPO, "examples", "gpt_pretrain.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", ["uint16", "uint32", "int32"])
def test_token_file_and_windows_match_jax(tmp_path, dtype):
    toks = np.random.default_rng(1).integers(0, 3000, 1001)
    tpath, jpath = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    tdata.write_token_file(tpath, toks, dtype=dtype)
    jdata.write_token_file(jpath, toks, dtype=dtype)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    assert json.load(open(tpath + ".meta.json")) == \
        json.load(open(jpath + ".meta.json"))
    t, j = tdata.IndexedTokenDataset(tpath, 31), \
        jdata.IndexedTokenDataset(jpath, 31)
    assert len(t) == len(j) == 1000 // 31 and t.max_token == j.max_token
    for i in (0, 1, len(t) - 1):
        np.testing.assert_array_equal(t[i], j[i])
        assert t[i].dtype == np.int32
    with pytest.raises(IndexError):
        t[len(t)]


def test_token_file_validation_matches_jax(tmp_path):
    for mod in (tdata, jdata):
        with pytest.raises(ValueError, match="integer dtype"):
            mod.write_token_file(str(tmp_path / "f.bin"), np.ones(3) * 1.5)
        with pytest.raises(ValueError, match="do not fit"):
            mod.write_token_file(str(tmp_path / "f.bin"), [70000])
        mod.write_token_file(str(tmp_path / "s.bin"), [1, 2, 3])
        with pytest.raises(ValueError, match="window"):
            mod.IndexedTokenDataset(str(tmp_path / "s.bin"), 8)


def test_legacy_sidecar_max_token_matches_jax(tmp_path):
    for mod in (tdata, jdata):
        path = str(tmp_path / f"{mod.__name__}.bin")
        mod.write_token_file(path, np.arange(50) % 17)
        meta = json.load(open(path + ".meta.json"))
        del meta["max_token"]
        json.dump(meta, open(path + ".meta.json", "w"))
        assert mod.IndexedTokenDataset(path, 8).max_token == 16
        assert json.load(open(path + ".meta.json"))["max_token"] == 16


@pytest.mark.parametrize("rank, size", [(0, 1), (1, 2), (2, 4)])
@pytest.mark.parametrize("consumed", [0, 12])
def test_samplers_match_jax(rank, size, consumed):
    for name, kw in (("MegatronPretrainingSampler", dict(drop_last=False)),
                     ("MegatronPretrainingRandomSampler", {})):
        t = getattr(ttdata, name)(100, consumed, 3, rank, size, **kw)
        j = getattr(jtdata, name)(100, consumed, 3, rank, size, **kw)
        assert list(t) == list(j) and len(t) == len(j)
    for mod in (ttdata, jtdata):
        with pytest.raises(RuntimeError, match="no samples left"):
            mod.MegatronPretrainingSampler(10, 10, 2, 0, 1)


def test_pretraining_batches_and_file_batches_match_jax(tmp_path):
    """The trainer's pool: the JAX trainer's ``file_batches`` windows and
    order, host numpy on the port's side; its vocabulary check too."""
    toks = np.random.default_rng(2).integers(0, 500, 4000)
    path = str(tmp_path / "c.bin")
    tdata.write_token_file(path, toks)
    ds = tdata.IndexedTokenDataset(path, 16)
    jds = jdata.IndexedTokenDataset(path, 16)
    sampler = ttdata.MegatronPretrainingSampler(len(ds), 0, 4, 0, 1)
    jsampler = jtdata.MegatronPretrainingSampler(len(jds), 0, 4, 0, 1)
    for (a, b), (c, d) in zip(tdata.pretraining_batches(ds, sampler),
                              jdata.pretraining_batches(jds, jsampler)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    jg = _jax_trainer()
    got = gpt_pretrain.file_batches(path, 5, 8, 16, 500)
    want = jg.file_batches(path, 5, 8, 16, 500)
    assert len(got) == len(want) == 5
    for (a, b), (c, d) in zip(got, want):
        assert isinstance(a, np.ndarray) and a.shape == (8, 16)
        np.testing.assert_array_equal(a, np.asarray(c))
        np.testing.assert_array_equal(b, np.asarray(d))
    for fb in (gpt_pretrain.file_batches, jg.file_batches):
        with pytest.raises(ValueError, match="max token id 499 >= model"):
            fb(path, 5, 8, 16, 499)
        with pytest.raises(ValueError, match="fewer than"):
            fb(path, 5, 1000, 16, 500)
