"""Training and evaluation steps (the port of `dl4ss_tpu/train/steps.py`).

Each `make_*_step(cfg, ...)` returns a function (state, batch) ->
(state, metrics). PyTorch runs eagerly, so a step is the loss, its
backward and the optimizer update in sequence; on the kernel route the
backward runs K5 and K6 (ops/rnn_kernels.py, ops/maskhead_kernels.py). A
step updates the state's model and optimizer state in place and returns
the same state with its step advanced.

Ported: the joint trainer (`make_train_step`, with the pit, identity and
si_sdr losses), the fused sample -> featurize -> step (`make_fused_step`)
and the teacher-forced eval step. Not yet: the dense, classifier and
adversarial steps, the recursive eval (ROADMAP P8, P9), the cRM loss (P9).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import functional_call

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.data.synth import featurize, sample_mixtures
from dl4ss_tpu_torch.eval.sisdr import si_sdr_pit
from dl4ss_tpu_torch.models.separator import Separator, SeparatorOutput
from dl4ss_tpu_torch.objectives.losses import mask_mse_loss, sum_to_one_loss
from dl4ss_tpu_torch.objectives.pit import pit_loss
from dl4ss_tpu_torch.ops.stft import istft_cfg
from dl4ss_tpu_torch.train.state import TrainState, make_optimizer


def _check_ported(cfg: Config) -> None:
    if cfg.is_complex_mask:
        raise NotImplementedError(
            "the complex-ratio-mask (cRM) loss is not ported yet (TDAA, "
            "ROADMAP P9)")


def _compute_cast(model: Separator, feats: dict, cfg: Config):
    """Mixed-precision compute (cfg.compute_dtype='bfloat16'): the model
    runs on bf16 casts of its f32 parameters and features, while the
    differentiated masters, the optimizer state and the loss math stay f32
    (the casts are differentiated back to the masters). Returns
    (bf16 parameters by name, or None for f32 compute, feats)."""
    if cfg.compute_dtype != "bfloat16" or cfg.is_complex_mask:
        return None, feats
    bf = torch.bfloat16
    params = {n: p.to(bf) if p.dtype == torch.float32 else p
              for n, p in model.named_parameters()}
    return params, dict(feats, mix_feas=feats["mix_feas"].to(bf))


def _separate(model: Separator, feats: dict, cfg: Config,
              spk_idx: Optional[torch.Tensor]) -> SeparatorOutput:
    """`separate` in the compute dtype: on the model itself, or through
    `functional_call` on the bf16 casts of its parameters."""
    params, cfeats = _compute_cast(model, feats, cfg)
    args = (cfeats["mix_feas"], cfg)
    kwargs = dict(spk_idx=spk_idx, mix_ri=cfeats.get("mix_ri"))
    if params is None:
        return model(*args, **kwargs)
    return functional_call(model, params, args, kwargs)


def _mixture_phasor(mix_ri: torch.Tensor) -> torch.Tensor:
    mix = torch.complex(mix_ri[..., 0], mix_ri[..., 1])
    return mix / torch.clamp(mix.abs(), min=1e-8)


def _separation_loss(model: Separator, feats: dict, cfg: Config):
    """Mask loss of the top-k path: pit or identity assignment of the
    masked magnitudes against the clean ones, or (loss_mode='si_sdr') the
    negative live-weighted uPIT SI-SDR of the resynthesised waveforms.
    Teacher-forced speakers (cfg.ground_truth); classifier selection
    waits for the BiLSTM kernel K7 (ROADMAP P8)."""
    live = feats["channel_live"].float()
    spk_idx = feats["spk_idx"] if cfg.ground_truth else None
    out = _separate(model, feats, cfg, spk_idx)
    if cfg.loss_mode == "si_sdr":
        pred_spec = out.pred.float() * _mixture_phasor(feats["mix_ri"])[:, None]
        wavs = istft_cfg(pred_spec, cfg, length=cfg.max_len)
        scores, perm = si_sdr_pit(wavs, feats["source_wavs"], live=live)
        loss = -scores.mean()
    else:
        pred = out.pred * live[..., None, None]
        target = feats["src_feas"]
        if cfg.loss_mode == "pit":
            loss, perm = pit_loss(pred, target)
        else:
            loss, perm = mask_mse_loss(pred, target, live), None
    aux = {"mask_loss": loss, "out": out, "perm": perm}
    if cfg.sum_loss_weight > 0:
        sl = sum_to_one_loss(out.masks * live[..., None, None])
        loss = loss + cfg.sum_loss_weight * sl
        aux["sum_loss"] = sl
    return loss, aux


def make_train_step(cfg: Config, steps_per_epoch: int = 1) -> Callable:
    """The canonical joint trainer (A17/A18/A19): teacher-forced speakers,
    mask MSE (+PIT) or SI-SDR, clipped Adam. step(state, feats) ->
    (state, metrics), updating the state in place."""
    if not cfg.ground_truth and cfg.loss_mode == "identity":
        raise ValueError(
            "ground_truth=False selects channels from the classifier, so "
            "channel k no longer aligns with source k — identity assignment "
            "is ill-posed in the top-k layout; use loss_mode='pit'/'si_sdr'.")
    _check_ported(cfg)
    opt = make_optimizer(cfg, steps_per_epoch)

    def step(state: TrainState, feats: dict):
        # every parameter of the ported separator: the JAX step excludes
        # only the discriminator, which is not ported
        params = list(state.model.parameters())
        for p in params:
            p.grad = None
        loss, aux = _separation_loss(state.model, feats, cfg)
        loss.backward()
        # parameters the loss does not reach (the classifier) get zeros,
        # as jax.grad gives them
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        grad_norm = opt.update(params, grads, state.opt_state)
        for p in params:
            p.grad = None
        metrics = {"loss": loss.detach(),
                   "mask_loss": aux["mask_loss"].detach(),
                   "grad_norm": grad_norm}
        if "sum_loss" in aux:
            metrics["sum_loss"] = aux["sum_loss"].detach()
        state.step += 1
        return state, metrics

    return step


def make_fused_step(cfg: Config, steps_per_epoch: int = 1) -> Callable:
    """Synthesis + STFT + train: step(state, bank) -> (state, metrics).
    The batch is drawn from the state's generator; on the kernel route the
    features come from K1 (the reference's CPU generator -> numpy STFT ->
    H2D copy -> GPU step, run on the device)."""
    inner = make_train_step(cfg, steps_per_epoch)

    def step(state: TrainState, bank: torch.Tensor):
        batch = sample_mixtures(state.generator, bank, cfg)
        return inner(state, featurize(batch, cfg))

    return step


def make_eval_step(cfg: Config) -> Callable:
    """Inference + resynthesis + SI-SDR, teacher-forced: step(model, feats)
    -> {pred_wavs, si_sdr (B,), perm, probs}. The compute dtype governs the
    forward; the masks are applied and scored in f32. The classifier's
    complement-mask trick waits for the classifier path (ROADMAP P8)."""

    def step(model: Separator, feats: dict, teacher_forced: bool = True,
             complement_mask: bool = False):
        if complement_mask or not teacher_forced:
            raise NotImplementedError(
                "classifier-selected speakers and the complement mask wait "
                "for the BiLSTM kernel K7 (ROADMAP P8)")
        _check_ported(cfg)
        with torch.no_grad():
            out = _separate(model, feats, cfg, feats["spk_idx"])
            pred_spec = (out.pred.float()
                         * _mixture_phasor(feats["mix_ri"])[:, None])
            wavs = istft_cfg(pred_spec, cfg, length=cfg.max_len)
            scores, perm = si_sdr_pit(wavs, feats["source_wavs"],
                                      live=feats.get("channel_live"))
        return {"pred_wavs": wavs, "si_sdr": scores, "perm": perm,
                "probs": out.probs.float()}

    return step
