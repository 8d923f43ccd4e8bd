"""The port's DCGAN amp example against the JAX package's, on the CPU.

The JAX example's ``train_step`` lives inside its ``main``; it is rebuilt
here from the example's module-level ``init_g``/``init_d``/``gen``/
``disc``/``bce`` with the same amp calls (three loss ids, D skipped
unless both of its gradients are finite).  Both sides start from the
JAX initialisation (``PRNGKey(0)`` for D, ``PRNGKey(1)`` for G, loaded
into the port's modules) and take the same numpy batches.  Both compute
in fp32; after 10 steps the parameters agree within 2e-5 absolute (the
Adam updates are 2e-4 a step; two frameworks' fp32 products in another
order), every loss within 1e-5 relative, and the three loss scales
exactly.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch.examples import dcgan_amp

torch.set_num_threads(1)  # the suite's parallel workers share the cores

ROOT = Path(__file__).resolve().parent.parent
PARAM_ATOL = 2e-5
LOSS_RTOL = 1e-5
STEPS, BATCH = 10, 16


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_dcgan_amp", ROOT / "examples" / "dcgan_amp.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_run(ex, opt_level, steps, batch):
    """The JAX example's step, as its main builds it; returns the
    parameters, the losses of each step and the loss scales."""
    mp = jamp.initialize(opt_level=opt_level, num_losses=3)
    amp_state = mp.init()
    opt_d, opt_g = JaxFusedAdam(lr=2e-4), JaxFusedAdam(lr=2e-4)
    params_d, params_g = ex.init_d(jax.random.PRNGKey(0)), ex.init_g(
        jax.random.PRNGKey(1))
    init = (jax.tree.map(np.asarray, params_d),
            jax.tree.map(np.asarray, params_g))
    st_d, st_g = opt_d.init(params_d), opt_g.init(params_g)

    @jax.jit
    def step(params_d, params_g, st_d, st_g, amp_state, real, z, z2):
        def d_loss_real(pd):
            return mp.scale_loss(amp_state, ex.bce(ex.disc(pd, real), 1.0),
                                 0)

        def d_loss_fake(pd):
            fake = ex.gen(params_g, z)
            return mp.scale_loss(amp_state, ex.bce(
                ex.disc(pd, jax.lax.stop_gradient(fake)), 0.0), 1)

        l_real, g_real = jax.value_and_grad(d_loss_real)(params_d)
        l_fake, g_fake = jax.value_and_grad(d_loss_fake)(params_d)
        scales = [s.loss_scale for s in amp_state.scaler_states]
        g_real, fin0, amp_state = mp.unscale_and_adjust(amp_state, g_real, 0)
        g_fake, fin1, amp_state = mp.unscale_and_adjust(amp_state, g_fake, 1)
        grads_d = jax.tree.map(jnp.add, g_real, g_fake)
        params_d, st_d = opt_d.step(st_d, grads_d, params_d,
                                    grads_finite=fin0 & fin1)

        def g_loss(pg):
            return mp.scale_loss(amp_state, ex.bce(
                ex.disc(params_d, ex.gen(pg, z2)), 1.0), 2)

        l_g, grads_g = jax.value_and_grad(g_loss)(params_g)
        scale_g = amp_state.scaler_states[2].loss_scale
        grads_g, fin2, amp_state = mp.unscale_and_adjust(amp_state, grads_g,
                                                         2)
        params_g, st_g = opt_g.step(st_g, grads_g, params_g,
                                    grads_finite=fin2)
        losses = (l_real / scales[0], l_fake / scales[1], l_g / scale_g)
        return params_d, params_g, st_d, st_g, amp_state, losses

    rng = np.random.default_rng(0)
    losses = []
    for _ in range(steps):
        real, z, z2 = dcgan_amp.batches(rng, batch)
        params_d, params_g, st_d, st_g, amp_state, ls = step(
            params_d, params_g, st_d, st_g, amp_state, real, z, z2)
        losses.append([float(x) for x in ls])
    scales = [float(s.loss_scale) for s in amp_state.scaler_states]
    return init, (params_d, params_g), np.array(losses), scales


def _port_run(init, opt_level, steps, batch):
    gan = dcgan_amp.DCGAN("cpu", opt_level)
    for net, tree in ((gan.netD, init[0]), (gan.netG, init[1])):
        net.load_state_dict({k: torch.from_numpy(np.array(v))
                             for k, v in tree.items()})
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(steps):
        real, z, z2 = (torch.from_numpy(a)
                       for a in dcgan_amp.batches(rng, batch))
        losses.append([float(x) for x in gan.step(real, z, z2)])
    return gan, np.array(losses)


@pytest.mark.parametrize("opt_level", ["O0", "O1"])
def test_dcgan_steps_match_jax(opt_level):
    ex = _jax_example()
    init, (pd, pg), want_losses, want_scales = _jax_run(
        ex, opt_level, STEPS, BATCH)
    gan, losses = _port_run(init, opt_level, STEPS, BATCH)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    for net, tree in ((gan.netD, pd), (gan.netG, pg)):
        for name, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(tree[name]),
                                       atol=PARAM_ATOL, rtol=0)
    assert gan.loss_scales() == want_scales
    assert want_scales == ([1.0] * 3 if opt_level == "O0" else
                           [2.0 ** 16] * 3)


def test_dcgan_main_prints_ok(capsys):
    scales = dcgan_amp.main(["--steps", "3", "--batch", "8", "--device",
                             "cpu"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK") and "loss scales" in out
    assert scales == [2.0 ** 16] * 3


def test_dcgan_overflow_skips_d_and_backs_off_its_scalers():
    """An inf in the real batch makes errD_real's gradients non-finite:
    D's step is skipped bit for bit, loss ids 0 and 1 keep their own
    scalers (only id 0 backs off), G still steps."""
    gan = dcgan_amp.DCGAN("cpu", "O1")
    before_d = [p.detach().clone() for p in gan.netD.parameters()]
    before_g = [p.detach().clone() for p in gan.netG.parameters()]
    real, z, z2 = (torch.from_numpy(a) for a in dcgan_amp.batches(
        np.random.default_rng(3), 8))
    real[0, 0] = float("inf")
    gan.step(real, z, z2)
    assert all(torch.equal(a, b) for a, b in zip(before_d,
                                                 gan.netD.parameters()))
    assert not all(torch.equal(a, b) for a, b in zip(
        before_g, gan.netG.parameters()))
    assert gan.loss_scales() == [2.0 ** 15, 2.0 ** 16, 2.0 ** 16]
