"""The training steps: the joint step (PIT mask loss, clipped Adam) and
TDAA's two-phase adversarial step, with optax's Adam and global-norm clip.

Adam: mu <- mu + (1 - b1)(g - mu), nu <- b2 nu + (1 - b2) g^2,
p <- p - lr * (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps), after the
gradient is scaled by clip / ||g|| where its global norm reaches `clip`.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List

import torch

from benchmark.reference import model
from benchmark.reference.dsp import stft

B1, B2, EPS = 0.9, 0.999, 1e-8


class Adam:
    """One optimizer over the named leaves it was made with."""

    def __init__(self, params: Dict[str, torch.Tensor], names: List[str],
                 c: dict):
        self.names = names
        self.mu = {n: torch.zeros_like(params[n]) for n in names}
        self.nu = {n: torch.zeros_like(params[n]) for n in names}
        self.count = 0
        self.c = c

    def lr(self) -> float:
        c, base = self.c, self.c["learning_rate"]
        if c["lr_schedule"] == "constant":
            return base
        if c["lr_schedule"] == "halve_per_epoch":
            return max(base * 0.5 ** (self.count // c["epoch_size"]),
                       c["lr_floor"])
        raise ValueError(f"unknown lr_schedule {c['lr_schedule']!r}")

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor]) -> None:
        """Applies one step in place."""
        norm = math.sqrt(sum(float((grads[n].double() ** 2).sum())
                             for n in self.names))
        clip = self.c["grad_clip_norm"]
        factor = clip / norm if clip and norm >= clip else 1.0
        lr = self.lr()
        self.count += 1
        for n in self.names:
            g = grads[n] * factor
            self.mu[n] += (1.0 - B1) * (g - self.mu[n])
            self.nu[n] = B2 * self.nu[n] + (1.0 - B2) * g * g
            mu_hat = self.mu[n] / (1.0 - B1 ** self.count)
            nu_hat = self.nu[n] / (1.0 - B2 ** self.count)
            params[n] -= lr * mu_hat / (torch.sqrt(nu_hat) + EPS)


def features(batch, c: dict):
    """|STFT| of the mixture (B, T, F) and of each source (B, K, T, F)."""
    mix = stft(batch.mix, c["frame_length"], c["frame_shift"]).abs()
    src = stft(batch.sources, c["frame_length"], c["frame_shift"]).abs()
    return mix, src


def pit_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of the best permutation's mean pair MSE."""
    k = pred.shape[1]
    pairs = ((pred[:, :, None] - target[:, None, :]) ** 2).mean(dim=(3, 4))
    scores = torch.stack([torch.stack([pairs[:, i, j] for i, j in
                                       enumerate(perm)]).mean(0)
                          for perm in itertools.permutations(range(k))], -1)
    return scores.min(dim=-1).values.mean()


def _grads(loss, params, names):
    leaves = [params[n] for n in names]
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(names, leaves, got)}


def generator_names(params) -> List[str]:
    return [n for n in params if not n.startswith("discriminator.")]


def joint_loss(params, mix, src, spk_idx, c: dict) -> torch.Tensor:
    """Teacher-forced separation, PIT MSE on the masked magnitudes."""
    return pit_mse(model.separate(params, mix, spk_idx, c).pred, src)


def d_loss_of(params, mix, src, spk_idx, c: dict) -> torch.Tensor:
    """The discriminator's MSE-GAN loss: the clean source spectra against
    the separator's detached output."""
    with torch.no_grad():
        fake = model.separate(params, mix, spk_idx, c).pred
    return (((model.discriminator(params, src) - 1.0) ** 2).mean()
            + (model.discriminator(params, fake) ** 2).mean())


def joint_step(params, opt: Adam, batch, c: dict):
    """One joint step: `joint_loss`, clipped Adam. Returns (loss, the
    gradients as the optimizer gets them, before its clip)."""
    mix, src = features(batch, c)
    with torch.enable_grad():
        leaves = {n: params[n].detach().requires_grad_() for n in opt.names}
        loss = joint_loss(dict(params, **leaves), mix, src, batch.spk_idx, c)
        grads = _grads(loss, leaves, opt.names)
    opt.update(params, grads)
    return float(loss.detach()), grads


def joint_late(params, batch, c: dict):
    """The joint step's loss at `params` on `batch`, without the step."""
    mix, src = features(batch, c)
    with torch.no_grad():
        return (float(joint_loss(params, mix, src, batch.spk_idx, c)),)


def adversarial_late(params, batch, c: dict):
    """The adversarial step's phase-1 loss at `params` on `batch`."""
    mix, src = features(batch, c)
    with torch.no_grad():
        return (float(d_loss_of(params, mix, src, batch.spk_idx, c)),)


def adversarial_step(params, g_opt: Adam, d_opt: Adam, batch, c: dict):
    """TDAA's step: phase 1 trains the discriminator on `d_loss_of`,
    phase 2 the separator on PIT MSE + 0.5 sum-to-one + the fooling term,
    against the updated discriminator. Returns ((d_loss, g_loss), the
    gradients of both optimizers as they get them, before their clip)."""
    mix, src = features(batch, c)
    with torch.enable_grad():
        d_leaves = {n: params[n].detach().requires_grad_()
                    for n in d_opt.names}
        d_loss = d_loss_of(dict(params, **d_leaves), mix, src,
                           batch.spk_idx, c)
        grads = _grads(d_loss, d_leaves, d_opt.names)
    d_opt.update(params, grads)
    with torch.enable_grad():
        g_leaves = {n: params[n].detach().requires_grad_()
                    for n in g_opt.names}
        p = dict(params, **g_leaves)
        out = model.separate(p, mix, batch.spk_idx, c)
        mask_l = pit_mse(out.pred, src)
        sum_l = ((out.masks.sum(dim=1) - 1.0) ** 2).mean()
        fool = ((model.discriminator(p, out.pred) - 1.0) ** 2).mean()
        g_loss = mask_l + 0.5 * sum_l + fool
        g_grads = _grads(g_loss, g_leaves, g_opt.names)
    g_opt.update(params, g_grads)
    grads.update(g_grads)
    return (float(d_loss.detach()), float(g_loss.detach())), grads
