"""Training and evaluation steps (the port of `dl4ss_tpu/train/steps.py`).

Each `make_*_step(cfg, ...)` returns a function (state, batch) ->
(state, metrics). PyTorch runs eagerly, so a step is the loss, its
backward and the optimizer update in sequence; on the kernel route the
backward runs K5 and K6 (the separator) or K8 (the classifier)
(ops/rnn_kernels.py, ops/maskhead_kernels.py). A step updates the state's
model and optimizer state in place and returns the same state with its
step advanced.

Ported: the joint trainer (`make_train_step`, with the pit, identity and
si_sdr losses, teacher-forced or classifier-selected speakers), the fused
sample -> featurize -> step (`make_fused_step`), the classifier trainer
(`make_classifier_step`), the eval step (teacher-forced or
classifier-selected, with the complement mask) and the recursive eval
step. Not yet: the dense and adversarial steps and the cRM loss (ROADMAP
P9).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.func import functional_call

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.data.synth import featurize, sample_mixtures
from dl4ss_tpu_torch.eval.sisdr import si_sdr_pit
from dl4ss_tpu_torch.models.separator import (Separator, SeparatorOutput,
                                              recursive_separate)
from dl4ss_tpu_torch.objectives.losses import (mask_mse_loss,
                                               multilabel_softmargin_loss,
                                               sum_to_one_loss)
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
              spk_idx: Optional[torch.Tensor],
              need_probs: bool = False) -> SeparatorOutput:
    """`separate` in the compute dtype: on the model itself, or through
    `functional_call` on the bf16 casts of its parameters. With no
    `spk_idx` the classifier selects the speakers."""
    params, cfeats = _compute_cast(model, feats, cfg)
    args = (cfeats["mix_feas"], cfg)
    kwargs = dict(spk_idx=spk_idx, mix_ri=cfeats.get("mix_ri"),
                  need_probs=need_probs)
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
    cfg.ground_truth teacher-forces the extraction channels with the true
    speakers; otherwise the classifier selects them. Selection indices
    carry no gradient, so the classifier itself trains only through
    `make_classifier_step`."""
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


def _backward_and_update(state: TrainState, opt, loss: torch.Tensor
                         ) -> torch.Tensor:
    """Differentiate `loss`, apply one optimizer update to every parameter
    of the ported separator (the JAX steps exclude only the discriminator,
    which is not ported) and return the global grad norm. Parameters the
    loss does not reach get zeros, as jax.grad gives them."""
    params = list(state.model.parameters())
    for p in params:
        p.grad = None
    loss.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    grad_norm = opt.update(params, grads, state.opt_state)
    for p in params:
        p.grad = None
    return grad_norm


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
        loss, aux = _separation_loss(state.model, feats, cfg)
        grad_norm = _backward_and_update(state, opt, loss)
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


def make_classifier_step(cfg: Config, steps_per_epoch: int = 1) -> Callable:
    """The standalone classifier trainer (A26/B16):
    MultiLabelSoftMarginLoss on 'who is in the mixture'. step(state, feats)
    -> (state, {loss, element_acc}), updating the state in place. Only the
    classifier gets a gradient; the optimizer still steps every parameter
    (with zeros), as in JAX."""
    opt = make_optimizer(cfg, steps_per_epoch)

    def step(state: TrainState, feats: dict):
        b = feats["mix_feas"].shape[0]
        dev = feats["mix_feas"].device
        live = feats["channel_live"].to(torch.bool)
        target = torch.zeros((b, cfg.num_speakers), device=dev)
        rows = torch.arange(b, device=dev)[:, None].expand_as(live)
        target[rows[live], feats["spk_idx"][live]] = 1.0
        params, cfeats = _compute_cast(state.model, feats, cfg)
        clf = state.model.classifier
        args, kwargs = (cfeats["mix_feas"], cfg), dict(logits=True)
        if params is None:
            logits = clf(*args, **kwargs)
        else:
            prefix = "classifier."
            logits = functional_call(
                clf, {n[len(prefix):]: p for n, p in params.items()
                      if n.startswith(prefix)}, args, kwargs)
        logits = logits.float()                   # f32 loss math
        loss = multilabel_softmargin_loss(logits, target)
        _backward_and_update(state, opt, loss)
        with torch.no_grad():
            pred = (torch.sigmoid(logits) > cfg.alpha).float()
            acc = (pred == target).float().mean()
        state.step += 1
        return state, {"loss": loss.detach(), "element_acc": acc}

    return step


def _mixture_magnitude(feats: dict, cfg: Config) -> torch.Tensor:
    """The LINEAR multiplicand of the masks (matches `_finish`'s choice)."""
    if cfg.log_spectral:
        ri = feats["mix_ri"]
        return torch.sqrt(ri[..., 0] ** 2 + ri[..., 1] ** 2)
    return feats["mix_feas"]


def make_recursive_eval_step(cfg: Config) -> Callable:
    """Recursive-extraction scoring (the RecuVer protocol): peel one
    speaker per step with `recursive_separate`, resynthesise each peeled
    spectrum with the mixture phase, and score permutation-resolved SI-SDR
    against the clean sources. step(model, feats) -> {pred_wavs, si_sdr,
    perm, spk_steps}; feats may carry `candidates` (B, S), the per-sample
    roster every peel step is restricted to."""

    def step(model: Separator, feats: dict):
        with torch.no_grad():
            extracted, spks = recursive_separate(
                model, feats["mix_feas"], cfg,
                allowed=feats.get("candidates"))
            pred_spec = (extracted.float()
                         * _mixture_phasor(feats["mix_ri"])[:, None])
            wavs = istft_cfg(pred_spec, cfg, length=cfg.max_len)
            refs = feats["source_wavs"]
            live = feats.get("channel_live")
            k_ref, steps = refs.shape[1], wavs.shape[1]
            if steps < k_ref:
                # fewer peel steps than reference channels: pad silent
                # estimate channels (they score against the dead refs)
                wavs = F.pad(wavs, (0, 0, 0, k_ref - steps))
            elif steps > k_ref:
                # more steps than refs: pad the refs with dead channels so
                # PIT stays square; live-masking keeps them out of the mean
                refs = F.pad(refs, (0, 0, 0, steps - k_ref))
                if live is None:
                    live = torch.ones((refs.shape[0], k_ref),
                                      dtype=torch.bool, device=refs.device)
                live = F.pad(live.to(torch.bool), (0, steps - k_ref))
            scores, perm = si_sdr_pit(wavs, refs, live=live)
        return {"pred_wavs": wavs, "si_sdr": scores, "perm": perm,
                "spk_steps": spks}

    return step


def make_eval_step(cfg: Config) -> Callable:
    """Inference + resynthesis + SI-SDR: step(model, feats) -> {pred_wavs,
    si_sdr (B,), perm, probs}. The compute dtype governs the forward; the
    masks are applied and scored in f32.

    `teacher_forced=False` lets the classifier select the speakers.
    `complement_mask`: when the classifier finds only one speaker above
    alpha in a 2-mix eval, the second channel's mask becomes 1 - mask_1,
    the reference's complement trick (main_run_sstune_TestVer.py:473-476).
    """

    def step(model: Separator, feats: dict, teacher_forced: bool = True,
             complement_mask: bool = False):
        _check_ported(cfg)
        with torch.no_grad():
            out = _separate(model, feats, cfg,
                            feats["spk_idx"] if teacher_forced else None,
                            need_probs=complement_mask)
            pred, probs = out.pred.float(), out.probs.float()
            if complement_mask and cfg.top_k == 2:
                one_spk = (probs > cfg.alpha).sum(dim=-1) <= 1     # (B,)
                comp = ((1.0 - out.masks[:, 0].float())
                        * _mixture_magnitude(feats, cfg))
                pred = pred.clone()
                pred[:, 1] = torch.where(one_spk[:, None, None], comp,
                                         pred[:, 1])
            pred_spec = pred * _mixture_phasor(feats["mix_ri"])[:, None]
            wavs = istft_cfg(pred_spec, cfg, length=cfg.max_len)
            scores, perm = si_sdr_pit(wavs, feats["source_wavs"],
                                      live=feats.get("channel_live"))
        return {"pred_wavs": wavs, "si_sdr": scores, "perm": perm,
                "probs": probs}

    return step
