"""DCGAN with two models, two optimizers and three loss scalers.

The port's twin of the JAX ``examples/dcgan_amp.py`` (reference:
examples/dcgan/main_amp.py:214-253, the multi-loss amp workflow): one
``amp.initialize(opt_level="O1", num_losses=3)`` handle whose three loss
ids scale errD_real, errD_fake and errG, each gradient unscaled and its
scaler adjusted by ``unscale_and_adjust`` (the ``multi_tensor_scale``
kernel on the card), and two ``FusedAdam`` optimizers (one
``multi_tensor_adam`` launch a step each on the card).  G and D are
small fully connected nets over synthetic 16 x 16 images; the batches
come from a seeded numpy generator, as in JAX.  The nets compute in
fp32: the JAX example casts nothing, so O1 here is its loss scaling.

    python -m apex_tpu_torch.examples.dcgan_amp --steps 50
    python -m apex_tpu_torch.examples.dcgan_amp --steps 5 --device cpu
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch import amp
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.utils.platform import resolve_device

IMG = 16
LATENT = 32


class Generator(nn.Module):
    """``tanh(leaky_relu(z @ fc) @ out)``: latent -> 256 -> an image."""

    def __init__(self, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.fc = nn.Parameter(0.05 * torch.randn(
            LATENT, 256, generator=generator, device=dev))
        self.out = nn.Parameter(0.05 * torch.randn(
            256, IMG * IMG, generator=generator, device=dev))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return torch.tanh(F.leaky_relu(z @ self.fc) @ self.out)


class Discriminator(nn.Module):
    """``(leaky_relu(x @ fc) @ out)[:, 0]``: an image -> 256 -> a logit."""

    def __init__(self, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.fc = nn.Parameter(0.05 * torch.randn(
            IMG * IMG, 256, generator=generator, device=dev))
        self.out = nn.Parameter(0.05 * torch.randn(
            256, 1, generator=generator, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (F.leaky_relu(x @ self.fc) @ self.out)[:, 0]


def bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Binary cross entropy on logits, JAX's stable form."""
    return torch.mean(torch.clamp(logits, min=0) - logits * target
                      + torch.log1p(torch.exp(-torch.abs(logits))))


class DCGAN:
    """The nets, their optimizers and the amp handle with its state: the
    example's init.  ``netD``/``netG`` are drawn from seeds 0 and 1 of
    ``torch.Generator`` (load other weights with ``load_state_dict``)."""

    def __init__(self, device=None, opt_level: str = "O1", lr: float = 2e-4):
        self.device = resolve_device(device)
        gen = lambda seed: torch.Generator(device=self.device).manual_seed(
            seed)
        self.netD = Discriminator(self.device, gen(0))
        self.netG = Generator(self.device, gen(1))
        self.mp = amp.initialize(opt_level=opt_level, num_losses=3)
        self.amp_state = self.mp.init(device=self.device)
        self.opt_d = FusedAdam(self.netD.parameters(), lr=lr)
        self.opt_g = FusedAdam(self.netG.parameters(), lr=lr)

    def step(self, real: torch.Tensor, z: torch.Tensor,
             z2: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """One step, as the JAX example's ``train_step``: D from two
        losses (ids 0 and 1, the step skipped unless both gradients are
        finite), then G from the third (id 2) through the updated D.
        Returns the three unscaled losses (device scalars, no host
        synchronisation)."""
        mp = self.mp
        pd: List[torch.Tensor] = list(self.netD.parameters())
        err_real = bce(self.netD(real), 1.0)
        g_real = torch.autograd.grad(
            mp.scale_loss(self.amp_state, err_real, 0), pd)
        with torch.no_grad():
            fake = self.netG(z)
        err_fake = bce(self.netD(fake), 0.0)
        g_fake = torch.autograd.grad(
            mp.scale_loss(self.amp_state, err_fake, 1), pd)
        g_real, fin0, self.amp_state = mp.unscale_and_adjust(
            self.amp_state, list(g_real), 0)
        g_fake, fin1, self.amp_state = mp.unscale_and_adjust(
            self.amp_state, list(g_fake), 1)
        for p, a, b in zip(pd, g_real, g_fake):
            p.grad = a + b
        self.opt_d.step(grads_finite=fin0 & fin1)

        pg: List[torch.Tensor] = list(self.netG.parameters())
        err_g = bce(self.netD(self.netG(z2)), 1.0)
        g_g = torch.autograd.grad(mp.scale_loss(self.amp_state, err_g, 2),
                                  pg)
        g_g, fin2, self.amp_state = mp.unscale_and_adjust(
            self.amp_state, list(g_g), 2)
        for p, g in zip(pg, g_g):
            p.grad = g
        self.opt_g.step(grads_finite=fin2)
        return err_real.detach(), err_fake.detach(), err_g.detach()

    def loss_scales(self) -> List[float]:
        """The three loss scales (a read of the device)."""
        return [float(s.loss_scale) for s in self.amp_state.scaler_states]


def batches(rng: np.random.Generator, batch: int):
    """One step's ``(real, z, z2)`` as numpy fp32, drawn as JAX draws them."""
    real = rng.normal(size=(batch, IMG * IMG)).astype(np.float32)
    z = rng.normal(size=(batch, LATENT)).astype(np.float32)
    z2 = rng.normal(size=(batch, LATENT)).astype(np.float32)
    return real, z, z2


def main(argv=None) -> List[float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--opt-level", default="O1")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    gan = DCGAN(args.device, args.opt_level)
    rng = np.random.default_rng(0)
    for _ in range(args.steps):
        real, z, z2 = (torch.from_numpy(a).to(gan.device)
                       for a in batches(rng, args.batch))
        gan.step(real, z, z2)
    scales = gan.loss_scales()
    print(f"done {args.steps} steps; loss scales: {scales}")
    print("OK")
    return scales


if __name__ == "__main__":
    main()
