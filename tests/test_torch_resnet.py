"""The port's ResNet, its NHWC convolution and SyncBatchNorm against the
JAX package's.

The same numpy images, weights and statistics go through
``apex_tpu.models.resnet`` / ``utils.convnet`` / ``parallel.
sync_batchnorm`` and their port twins.  The JAX ResNet runs outside any
mesh with ``sync_bn_axis=None`` (the port's ``"dp"`` at one replica is
the same reduction); the port runs on CPU tensors.  The models are at
width 8 on 32x32 images, batch 8, every leaf drawn from a numpy seed in
the shapes of JAX's trees (``jax.eval_shape`` of its init): each block's
last norm scale around 0, as JAX zero-initialises it, but not at 0, so
that it carries gradients.

Tolerances, fp32 on both sides: convolutions and the max pool to 1e-5
(1e-4 relative for the 7x7 sums); batch norm outputs and statistics to
1e-5; the ResNets' logits to 1e-4 of their largest value and every
gradient to 5e-4 of its tensor's largest (a training-mode norm divides
by a batch standard deviation, and at the last stage's 1x1 maps of 8
images a different summation order in the statistics moves its
gradients by a few 1e-5 relative), the new running statistics to 1e-4
of their largest; eval mode (the running statistics) to 1e-5.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from apex_tpu.amp.policy import get_policy as jax_get_policy
from apex_tpu.models.resnet import ResNet as JaxResNet
from apex_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from apex_tpu.parallel import sync_batchnorm as jax_bn
from apex_tpu.utils import convnet as jax_conv
from apex_tpu_torch import convert
from apex_tpu_torch.amp import get_policy
from apex_tpu_torch.examples import imagenet_amp
from apex_tpu_torch.models import ResNet, ResNetConfig, resnet50
from apex_tpu_torch.parallel import SyncBatchNorm, sync_batch_norm
from apex_tpu_torch.utils import convnet

torch.set_num_threads(1)  # the suite's parallel workers share the cores


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("k, stride, size",
                         list(itertools.product((1, 3, 7), (1, 2), (7, 8))))
def test_conv_nhwc_matches_xla_same_padding(k, stride, size):
    rng = np.random.RandomState(k * 10 + stride + size)
    x = rng.randn(2, size, size, 3).astype(np.float32)
    w = rng.randn(k, k, 3, 5).astype(np.float32)
    g = rng.randn(2, -(-size // stride), -(-size // stride), 5).astype(
        np.float32)

    def f(x, w):
        return jnp.sum(jax_conv.conv_nhwc(x, w, stride) * g)

    want = np.asarray(jax_conv.conv_nhwc(x, w, stride))
    want_dx, want_dw = jax.grad(f, argnums=(0, 1))(x, w)
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    got = convnet.conv_nhwc(tx, tw, stride)
    (got * _t(g)).sum().backward()
    assert got.shape == want.shape
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), want, **tol)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), **tol)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_dw), **tol)


def test_same_pads_are_xla_s_asymmetric_ones():
    # the 7x7 stride-2 stem on 224 pads 2 before and 3 after, a 3x3
    # stride-2 conv on 56 pads 0 and 1; stride 1 is symmetric
    assert convnet.same_pads((224, 224), (7, 7), 2) == ((2, 3), (2, 3))
    assert convnet.same_pads((56,), (3,), 2) == ((0, 1),)
    assert convnet.same_pads((56,), (1,), 2) == ((0, 0),)
    assert convnet.same_pads((55,), (3,), 1) == ((1, 1),)
    # padding="VALID" and explicit pads pass through
    x, w = torch.randn(1, 9, 9, 2), torch.randn(3, 3, 2, 4)
    assert convnet.conv_nhwc(x, w, 2, "VALID").shape == (1, 4, 4, 4)
    assert convnet.conv_nhwc(x, w, 1, ((0, 2), (1, 0))).shape == (1, 9, 8, 4)


@pytest.mark.parametrize("size", [7, 8, 112])
def test_max_pool_matches_xla_same(size):
    rng = np.random.RandomState(size)
    x = rng.randn(2, size, size, 4).astype(np.float32)
    out = -(-size // 2)
    g = rng.randn(2, out, out, 4).astype(np.float32)

    def pool(x):
        return lax.reduce_window(x, -jnp.inf, lax.max, (1, 3, 3, 1),
                                 (1, 2, 2, 1), "SAME")

    want = np.asarray(pool(x))
    want_dx = np.asarray(jax.grad(lambda x: jnp.sum(pool(x) * g))(x))
    tx = _t(x).requires_grad_()
    got = convnet.max_pool_nhwc(tx, 3, 2)
    (got * _t(g)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(tx.grad.numpy(), want_dx)


def test_he_init_scale():
    w = convnet.he_init(torch.Generator().manual_seed(0), (3, 3, 64, 128),
                        torch.float32)
    assert abs(w.std().item() / np.sqrt(2.0 / (9 * 64)) - 1) < 0.02


@pytest.mark.parametrize("training, fuse_relu, affine",
                         [(True, False, True), (True, True, True),
                          (False, True, True), (False, False, False),
                          (True, False, False)])
def test_sync_batch_norm_matches_jax(training, fuse_relu, affine):
    rng = np.random.RandomState(int(training) + 2 * fuse_relu)
    x = (2 + 3 * rng.randn(4, 5, 5, 6)).astype(np.float32)
    w = (1 + 0.1 * rng.randn(6)).astype(np.float32) if affine else None
    b = (0.1 * rng.randn(6)).astype(np.float32) if affine else None
    rm = rng.randn(6).astype(np.float32)
    rv = (1 + rng.rand(6)).astype(np.float32)
    g = rng.randn(*x.shape).astype(np.float32)
    kw = dict(training=training, momentum=0.2, eps=1e-3,
              fuse_relu=fuse_relu)

    def f(x):
        out, m, v = jax_bn.sync_batch_norm(x, w, b, rm, rv, **kw)
        return jnp.sum(out * g), (out, m, v)

    (_, (want, want_m, want_v)), want_dx = jax.value_and_grad(
        f, has_aux=True)(x)
    tx = _t(x).requires_grad_()
    out, m, v = sync_batch_norm(
        tx, None if w is None else _t(w), None if b is None else _t(b),
        _t(rm), _t(rv), **kw)
    (out * _t(g)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), **tol)
    np.testing.assert_allclose(m.numpy(), np.asarray(want_m), **tol)
    np.testing.assert_allclose(v.numpy(), np.asarray(want_v), **tol)
    assert not m.requires_grad and not v.requires_grad
    if fuse_relu:
        assert (out >= 0).all()


def test_sync_batch_norm_module_keeps_running_stats():
    bn = SyncBatchNorm(momentum=0.5)
    assert bn.weight is None
    x = torch.randn(8, 3, 3, 4) * 2 + 1
    bn(x)
    assert bn.num_features == 4 and bn.weight.shape == (4,)
    n = x.numel() // 4
    mean = x.reshape(-1, 4).mean(0)
    var = x.reshape(-1, 4).var(0, unbiased=True)
    torch.testing.assert_close(bn.running_mean, 0.5 * mean, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(bn.running_var, 0.5 + 0.5 * var, rtol=1e-4,
                               atol=1e-5)
    before = bn.running_mean.clone()
    out = bn(x, use_running_average=True)
    assert torch.equal(bn.running_mean, before)
    torch.testing.assert_close(out, (x - bn.running_mean) / torch.sqrt(
        bn.running_var + bn.eps))
    assert n == 72


def test_more_than_one_replica_raises(monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    x = torch.randn(2, 3, 3, 4)
    with pytest.raises(NotImplementedError, match="queue A item 9"):
        sync_batch_norm(x, None, None, None, None, axis_name="dp")
    with pytest.raises(NotImplementedError, match="queue A item 9"):
        sync_batch_norm(x, None, None, None, None, axis_name="dp",
                        process_group_size=1)
    # no axis: the local batch, as JAX's; eval reads the running stats
    sync_batch_norm(x, None, None, None, None)
    sync_batch_norm(x, None, None, torch.zeros(4), torch.ones(4),
                    training=False, axis_name="dp")
    cfg = ResNetConfig(depth=18, width=4, num_classes=3)
    assert cfg.sync_bn_axis == "dp"
    with pytest.raises(NotImplementedError, match="queue A item 9"):
        ResNet(cfg, device="cpu")(torch.randn(2, 16, 16, 3))


def _draw(shapes, rng, last_bn):
    """Leaves for a tree of ``jax.ShapeDtypeStruct``s (no JAX init run):
    He-scaled conv weights, norm scales around 1 (around 0 for each
    block's last norm, ``last_bn``, which JAX zero-initialises), biases
    and means around 0, variances around 1, an ``fc`` scaled by its
    fan-in."""
    def leaf(path, sd):
        name = str(path[-1].key)
        if name == "scale" and str(path[-2].key) == last_bn:
            return (0.3 * rng.randn(*sd.shape)).astype(sd.dtype)
        if len(sd.shape) == 4:
            std = np.sqrt(2.0 / np.prod(sd.shape[:3]))
        elif len(sd.shape) == 2:
            std = 1.0 / np.sqrt(sd.shape[0])
        else:
            std = 0.3
        base = 1.0 if name in ("scale", "var") else 0.0
        a = base + std * (rng.rand(*sd.shape) if name == "var"
                          else rng.randn(*sd.shape))
        return a.astype(np.float32).astype(sd.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def models(depth, seed, level="O0", width=8, sync_bn_axis=None):
    """The JAX and port ResNets at ``width`` from one drawn tree."""
    kw = dict(depth=depth, width=width, num_classes=10)
    jm = JaxResNet(JaxResNetConfig(**kw, policy=jax_get_policy(level),
                                   sync_bn_axis=sync_bn_axis))
    tm = ResNet(ResNetConfig(**kw, policy=get_policy(level)), device="cpu")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    params, stats = _draw(shapes, np.random.RandomState(seed),
                          "bn3" if depth >= 50 else "bn2")
    tm.load_state_dict(convert.resnet_from_jax(params, stats))
    return jm, tm, params, stats


@pytest.mark.parametrize("depth", [18, 50])
@pytest.mark.parametrize("training", [True, False])
def test_resnet_matches_jax(depth, training):
    jm, tm, params, stats = models(depth, seed=depth + training)
    rng = np.random.RandomState(depth)
    x = rng.randn(8, 32, 32, 3).astype(np.float32)
    g = rng.randn(8, 10).astype(np.float32)

    def f(p):
        logits, new = jm.apply(p, stats, jnp.asarray(x), training=training)
        return jnp.sum(logits * g), (logits, new)

    (_, (want, want_new)), want_g = jax.jit(
        jax.value_and_grad(f, has_aux=True))(params)
    logits, new = tm.apply(None, None, _t(x), training)
    (logits * _t(g)).sum().backward()
    assert logits.dtype == torch.float32
    scale = np.abs(np.asarray(want)).max()
    band = 1e-4 if training else 1e-5
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               rtol=0, atol=band * scale)
    want_g = convert.params_from_jax(jax.tree.map(np.asarray, want_g))
    assert {n for n, _ in tm.named_parameters()} == set(want_g)
    gband = 5e-4 if training else 1e-5
    for name, p in tm.named_parameters():
        want_n = want_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want_n, rtol=0,
                                   atol=gband * np.abs(want_n).max() + 1e-9,
                                   err_msg=name)
    want_new = convert.params_from_jax(jax.tree.map(np.asarray, want_new))
    got_new = convert.params_from_jax(jax.tree.map(
        lambda t: t.detach().numpy(), new))
    assert set(got_new) == set(want_new)
    for name, v in got_new.items():
        w = want_new[name].numpy()
        np.testing.assert_allclose(v.numpy(), w, rtol=0,
                                   atol=band * np.abs(w).max(), err_msg=name)


def test_forward_writes_the_running_stats_and_eval_reads_them():
    _, tm, params, stats = models(18, seed=3)
    x = torch.randn(8, 32, 32, 3)
    before = tm.bn_stem.mean.clone()
    logits_apply, new = tm.apply(None, None, x, True)
    assert torch.equal(tm.bn_stem.mean, before)       # apply writes nothing
    logits = tm(x)                                     # training mode
    assert torch.equal(logits, logits_apply)
    assert torch.equal(tm.bn_stem.mean, new["bn_stem"]["mean"])
    tm.eval()
    with torch.no_grad():
        ev = tm(x)
        again, same = tm.apply(None, None, x, training=False)
    assert torch.equal(ev, again)
    assert same["bn_stem"]["mean"] is tm.bn_stem.mean


@pytest.mark.parametrize("level", ["O0", "O5"])
def test_resnet_trees_round_trip_exactly(level):
    jm, tm, params, stats = models(50, seed=1, level=level, width=4)
    assert set(convert.resnet_from_jax(params, stats)) == \
        set(tm.state_dict())
    assert tm.stages[1][0].conv2.shape == (3, 3, 8, 8)         # HWIO
    back = convert.resnet_to_jax(tm.state_dict())
    for want, got in zip((params, stats), back):
        want_l = jax.tree_util.tree_leaves_with_path(want)
        got_l = jax.tree_util.tree_leaves_with_path(got)
        assert [p for p, _ in want_l] == [p for p, _ in got_l]
        for (path, a), (_, b) in zip(want_l, got_l):
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    # the policy: bf16 convs, fp32 norms (keep_norm_fp32), zero last scale
    fresh = resnet50(width=4, num_classes=5, policy=get_policy(level),
                     device="cpu")
    if level == "O5":
        assert fresh.stages[0][0].conv1.dtype == torch.bfloat16
        assert fresh.stages[0][0].bn3.scale.dtype == torch.float32
    assert (fresh.stages[0][0].bn3.scale == 0).all()
    assert (fresh.stages[0][0].bn1.scale == 1).all()


def test_flops_per_image_counts_every_conv(monkeypatch):
    """The MFU numerator equals the FLOPs of the convolutions a forward
    actually runs (read from their shapes) plus the classifier's."""
    tm = ResNet(ResNetConfig(depth=50, width=8, num_classes=10,
                             policy=get_policy("O0")), device="cpu")
    counted = []
    real = torch.nn.functional.conv2d

    def spy(x, w, *a, **kw):
        y = real(x, w, *a, **kw)
        counted.append(2 * y.shape[2] * y.shape[3] * w[0].numel()
                       * w.shape[0])
        return y

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    with torch.no_grad():
        tm.apply(None, None, torch.randn(1, 40, 40, 3), training=False)
    assert tm.flops_per_image(40) == sum(counted) + 2 * tm.fc.weight.numel()
    assert len(counted) == 1 + 16 * 3 + 4


def test_imagenet_example_trains_two_steps_on_the_cpu(capsys, tmp_path):
    """Two steps and a validation pass; then the checkpoint and metrics
    flags: ``--resume`` needs ``--checkpoint-dir``, an epoch's checkpoint
    (and ``best.ckpt``) verifies, and the JSONL holds a step record a
    step and the save events."""
    import json

    from apex_tpu_torch import checkpoint

    out = imagenet_amp.main([
        "--depth", "18", "--batch-size", "4", "--image-size", "32",
        "--num-classes", "10", "--steps-per-epoch", "2", "--eval-steps",
        "1", "--device", "cpu"])
    assert len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"]))
    assert 0.0 <= out["prec1"] <= out["prec5"] <= 100.0
    text = capsys.readouterr().out
    assert "prec@1" in text and "val:" in text
    with pytest.raises(SystemExit, match="--resume needs --checkpoint-dir"):
        imagenet_amp.main(["--resume", "--device", "cpu"])
    ck, jsonl = tmp_path / "ck", tmp_path / "m.jsonl"
    out = imagenet_amp.main([
        "--depth", "18", "--batch-size", "2", "--image-size", "16",
        "--num-classes", "10", "--steps-per-epoch", "2", "--eval-steps",
        "1", "--device", "cpu", "--checkpoint-dir", str(ck),
        "--metrics-jsonl", str(jsonl)])
    best = out["best_prec1"] > 0          # a new best saves best.ckpt too
    assert checkpoint.verify(str(ck / "step_0")) == []
    assert (ck / "best.ckpt").is_dir() == best
    recs = [json.loads(x) for x in jsonl.read_text().splitlines()]
    assert [r["step"] for r in recs if r["kind"] == "step"] == [0, 1]
    assert [r["event"] for r in recs if r["kind"] == "event"] == \
        ["checkpoint_save"] * (1 + best)


def test_imagenet_pool_is_the_jax_example_s():
    pool = imagenet_amp.synthetic_pool(0, 2, 3, 8, 10, "cpu")
    rng = np.random.default_rng(0)
    for images, labels in pool:
        np.testing.assert_array_equal(
            images.numpy(), rng.normal(size=(3, 8, 8, 3)).astype(np.float32))
        np.testing.assert_array_equal(labels.numpy(),
                                      rng.integers(0, 10, (3,)))
