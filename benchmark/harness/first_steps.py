"""`TrainDriver.__init__`'s tail for a driver that builds its own state:
the first STEPS steps recorded, then the warm-up.

The first step's gradient of each leaf is the first that autograd hands
over (a discriminator's comes in phase 1). The hook returns None, so the
copy is its own: an optimizer whose clip scales the gradients in place
leaves it as autograd handed it over.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from benchmark.harness.training import STEPS, Record


def first_steps(driver, model: torch.nn.Module,
                before: Optional[Callable[[], None]] = None) -> None:
    """Runs `driver.step_once` STEPS times, `before` ahead of each, into
    `driver.record`, then the traffic's warm-up units."""
    grads: Dict[str, torch.Tensor] = {}

    def keep(g, n):
        grads.setdefault(n, g.detach().clone())

    hooks = [p.register_hook(lambda g, n=n: keep(g, n))
             for n, p in model.named_parameters()]
    losses = []
    for i in range(STEPS):
        if before is not None:
            before()
        m = driver.step_once()
        losses.append([float(m[k]) for k in driver.loss_keys])
        if i == 0:
            for h in hooks:
                h.remove()
    driver.record = Record(losses, grads, {
        n: p.detach().clone() for n, p in model.named_parameters()}, [])
    driver.late = None
    driver.window_losses = []
    for _ in range(driver.ctx.traffic["warmup_units"]):
        driver.unit()
    driver.sync()
    driver.window_losses.clear()
