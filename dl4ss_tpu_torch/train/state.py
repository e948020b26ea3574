"""Train state, learning-rate schedules and optimizers (the port of
`dl4ss_tpu/train/state.py`).

The optimizers follow optax's formulas, not torch.optim's: Adam and Nadam
as `optax.adam` / `optax.nadam` (torch.optim.NAdam's momentum decay is
another algorithm), and the global-norm clip as
`optax.clip_by_global_norm`: g * max/||g|| when ||g|| >= max, with no
epsilon in the denominator (torch's `clip_grad_norm_` adds 1e-6). They
update the parameters and their moments in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Union

import torch

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.models.memory import (MemorySlots, init_memory,
                                           memory_rows)
from dl4ss_tpu_torch.models.separator import Separator, init_separator


@dataclasses.dataclass
class AdamState:
    count: int                      # updates applied so far
    mu: List[torch.Tensor]          # first moments, one per parameter
    nu: List[torch.Tensor]          # second moments


@dataclasses.dataclass
class TrainState:
    """Everything a training step carries: the step counter, the model
    (its parameters are the f32 masters), the optimizer state of the
    generator's parameters (every subtree but the discriminator), the
    generator that draws the batches (the JAX state's PRNG key), when the
    model has a discriminator its own optimizer state, and the speaker
    memory where the state was built with one."""
    step: int
    model: Separator
    opt_state: AdamState
    generator: torch.Generator
    d_opt_state: Optional[AdamState] = None
    memory: Optional[MemorySlots] = None


def generator_params(model: Separator) -> List[torch.Tensor]:
    """The parameters the separation trainers update: all but the
    discriminator's (JAX `_gen_params`), in `named_parameters` order."""
    return [p for n, p in model.named_parameters()
            if not n.startswith("discriminator.")]


def discriminator_params(model: Separator) -> List[torch.Tensor]:
    return list(model.discriminator.parameters())


def make_schedule(cfg: Config, steps_per_epoch: int
                  ) -> Union[float, Callable[[int], float]]:
    """lr schedules used by the reference entry points:
      constant        — Adam 2e-4 (Torch_multi/main_run.py:443)
      halve_per_epoch — *0.5 each epoch, floor lr_floor (TestVer:596-600)
      halve_50        — *0.5 every 50 epochs (test_multi_labels_speech.py:405-407)
      cosine          — half-cosine decay over cfg.max_epoch epochs to lr_floor
    A schedule maps the count of updates already applied to the lr.
    """
    base = cfg.learning_rate
    if cfg.lr_schedule == "constant":
        return base
    if cfg.lr_schedule == "cosine":
        total = max(cfg.max_epoch * steps_per_epoch, 1)

        def cosine(step: int) -> float:
            frac = min(step / total, 1.0)
            return max(base * 0.5 * (1.0 + math.cos(math.pi * frac)),
                       cfg.lr_floor)
        return cosine
    if cfg.lr_schedule == "halve_per_epoch":
        def halve_per_epoch(step: int) -> float:
            return max(base * 0.5 ** (step // steps_per_epoch), cfg.lr_floor)
        return halve_per_epoch
    if cfg.lr_schedule == "halve_50":
        def halve_50(step: int) -> float:
            return base * 0.5 ** (step // (50 * steps_per_epoch))
        return halve_50
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Optimizer:
    """optax.adam / optax.nadam (b1 0.9, b2 0.999, eps 1e-8) on a schedule,
    behind optax.clip_by_global_norm(cfg.grad_clip_norm) when that is set,
    as `make_optimizer` chains them in JAX."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, cfg: Config, steps_per_epoch: int = 1):
        if cfg.optimizer not in ("adam", "nadam"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.nesterov = cfg.optimizer == "nadam"
        self.clip = cfg.grad_clip_norm
        self.schedule = make_schedule(cfg, steps_per_epoch)

    def init(self, params: List[torch.Tensor]) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    def lr(self, count: int) -> float:
        return self.schedule(count) if callable(self.schedule) \
            else self.schedule

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: AdamState, norm: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """Apply one update to `params` and `state` in place (`grads` may be
        scaled in place by the clip). Returns the global norm of the
        incoming grads, before the clip: `norm` when the caller has it (a
        mesh's, over every rank's share of the parameters)."""
        if norm is None:
            norm = global_norm(grads)
        if self.clip:
            # optax: g if ||g|| < max else (g / ||g||) * max; one factor
            # per update here, so the clipped grads can differ in the last
            # bit from optax's
            factor = torch.where(norm < self.clip, torch.ones_like(norm),
                                 self.clip / norm)
            torch._foreach_mul_(grads, factor)
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        torch._foreach_lerp_(state.mu, grads, 1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - b2)
        mu_hat = torch._foreach_div(state.mu, 1.0 - b1 ** count)
        if self.nesterov:
            # b1 * mu / (1 - b1^(count+1)) + (1 - b1) * g / (1 - b1^count)
            torch._foreach_mul_(mu_hat, b1 * (1.0 - b1 ** count)
                                / (1.0 - b1 ** (count + 1)))
            torch._foreach_add_(mu_hat, grads,
                                alpha=(1.0 - b1) / (1.0 - b1 ** count))
        denom = torch._foreach_div(state.nu, 1.0 - b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(mu_hat, denom)
        torch._foreach_add_(params, mu_hat, alpha=-self.lr(state.count))
        state.count = count
        return norm


def make_optimizer(cfg: Config, steps_per_epoch: int = 1) -> Optimizer:
    return Optimizer(cfg, steps_per_epoch)


def create_train_state(cfg: Config, seed: int = 1, steps_per_epoch: int = 1,
                       device=None, model: Optional[Separator] = None,
                       num_frames: Optional[int] = None,
                       with_memory: bool = False) -> TrainState:
    """A fresh state: the separator from `seed` (or the given model), its
    discriminator sized for `num_frames` frames (default cfg.num_frames),
    zero moments for the generator's parameters (and for the
    discriminator's, under cfg.use_discriminator), step 0, the batch
    generator seeded from seed + 1 and, `with_memory`, an empty speaker
    memory of memory_rows(cfg) rows of cfg.query_dim."""
    if model is None:
        model = init_separator(cfg, torch.Generator().manual_seed(seed),
                               device, num_frames)
    opt = make_optimizer(cfg, steps_per_epoch)
    d_opt_state = (opt.init(discriminator_params(model))
                   if cfg.use_discriminator else None)
    memory = None
    if with_memory:
        memory = init_memory(memory_rows(cfg), cfg.query_dim,
                             next(model.parameters()).device)
    return TrainState(step=0, model=model,
                      opt_state=opt.init(generator_params(model)),
                      generator=torch.Generator().manual_seed(seed + 1),
                      d_opt_state=d_opt_state, memory=memory)
