"""Query-conditioned separation training, the audio-visual and image
variants (the port of `dl4ss_tpu/train/query_trainer.py`).

The separator runs with `queries` from the video or image encoder, one per
extraction channel, trained jointly with the encoder and mask head on the
mask loss plus the reference's auxiliary speaker cross-entropy on the
video query's logits (CrossEntropyLoss, Torch_multi/main_run.py:451). On
the `grid_video` preset the separator takes the kernel route: K1 in
`featurize`, K2 / K5 in the encoder, K3 / K6 in the fused dot head; the
video query's BiLSTM runs K7 / K8 on the card under the same flag
(`models.query.query_rnn`).

Batch contract (feats): mix_feas (B,T,F), src_feas (B,K,T,F),
channel_live (B,K), spk_idx (B,K), mix_ri, source_wavs, and query_video
(B,K,Tf,H,W,3) or query_image (B,K,28,28,1).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.eval.sisdr import si_sdr, si_sdr_pit
from dl4ss_tpu_torch.models.query import (apply_image_query,
                                          apply_video_query,
                                          init_image_query, init_video_query)
from dl4ss_tpu_torch.models.separator import Separator, init_separator
from dl4ss_tpu_torch.objectives.losses import mask_mse_loss
from dl4ss_tpu_torch.objectives.pit import pit_loss
from dl4ss_tpu_torch.ops.stft import istft_cfg
from dl4ss_tpu_torch.train.checkpoint import (init_params_from, latest_step,
                                              restore_checkpoint,
                                              save_checkpoint)
from dl4ss_tpu_torch.train.metrics import MetricsWriter
from dl4ss_tpu_torch.train.state import (TrainState, create_train_state,
                                         generator_params, make_optimizer)
from dl4ss_tpu_torch.train.steps import (_backward_and_update,
                                         _mixture_phasor)


def init_query_separator(cfg: Config, query_source: str = "video",
                         video_trunk: str = "conv", frame_hw=(48, 48),
                         generator=None, device=None) -> Separator:
    """The separator with a `video_query` or `image_query` subtree."""
    device = resolve_device(device)
    model = init_separator(cfg, generator, device)
    if query_source == "video":
        model.video_query = init_video_query(
            cfg, frame_hw=frame_hw, trunk=video_trunk, generator=generator,
            device=device)
    else:
        model.image_query = init_image_query(cfg, generator=generator,
                                             device=device)
    return model


def query_batch(generator: torch.Generator, bank: torch.Tensor,
                cfg: Config, query_key: str, query_bank: torch.Tensor
                ) -> dict:
    """One training batch of the video / image-query modes (the JAX CLI's
    `make_batch`): mixtures drawn from `bank` by `generator`, their
    features, and for every channel one of its speaker's query entries
    ((S, V, ...) clips or images) under `query_key`."""
    from dl4ss_tpu_torch.data.synth import featurize, sample_mixtures
    b = sample_mixtures(generator, bank, cfg)
    feats = featurize(b, cfg)
    ci = torch.randint(0, query_bank.shape[1], b.spk_idx.shape,
                       generator=generator).to(bank.device)
    feats[query_key] = query_bank[b.spk_idx, ci]          # (B, K, ...)
    return feats


def _queries_and_logits(model: Separator, feats: dict, cfg: Config,
                        query_source: str):
    if query_source == "video":
        qv = feats["query_video"]                       # (B,K,Tf,H,W,3)
        b, k = qv.shape[:2]
        logits, q = apply_video_query(model.video_query,
                                      qv.reshape((b * k,) + qv.shape[2:]),
                                      cfg.use_pallas_rnn)
        return q.reshape(b, k, -1), logits.reshape(b, k, -1)
    qi = feats["query_image"]                           # (B,K,H,W,C)
    b, k = qi.shape[:2]
    q = apply_image_query(model.image_query,
                          qi.reshape((b * k,) + qi.shape[2:]))
    return q.reshape(b, k, -1), None


def make_query_train_step(cfg: Config, query_source: str = "video",
                          steps_per_epoch: int = 1,
                          aux_class_weight: float = 1.0) -> Callable:
    """step(state, feats) -> (state, {loss, mask_loss[, query_ce],
    grad_norm}), updating the state in place. Every parameter but the
    discriminator's gets an update; the frozen Inception trunk's gradient
    is zero, so its update is too."""
    opt = make_optimizer(cfg, steps_per_epoch)

    def step(state: TrainState, feats: dict):
        model = state.model
        live = feats["channel_live"].float()
        queries, logits = _queries_and_logits(model, feats, cfg,
                                              query_source)
        out = model(feats["mix_feas"], cfg, queries=queries,
                    mix_ri=feats.get("mix_ri"))
        pred = out.pred * live[..., None, None]
        if cfg.loss_mode == "si_sdr":
            # time-domain fine-tune through the mixture-phase iSTFT;
            # channels are query-designated, so the assignment is identity
            wavs = istft_cfg(pred.float() * _mixture_phasor(
                feats["mix_ri"])[:, None], cfg, length=cfg.max_len)
            scores = si_sdr(wavs, feats["source_wavs"])
            mask_l = -(scores * live).sum() / torch.clamp(live.sum(),
                                                          min=1.0)
        elif cfg.loss_mode == "pit":
            mask_l, _ = pit_loss(pred, feats["src_feas"])
        else:
            mask_l = mask_mse_loss(pred, feats["src_feas"], live)
        total = mask_l
        metrics = {"mask_loss": mask_l.detach()}
        if logits is not None and aux_class_weight > 0:
            ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                                 feats["spk_idx"].reshape(-1).long(),
                                 reduction="none").reshape(live.shape)
            ce = (ce * live).mean()
            total = total + aux_class_weight * ce
            metrics["query_ce"] = ce.detach()
        grad_norm = _backward_and_update(generator_params(model),
                                         state.opt_state, opt, total)
        state.step += 1
        return state, {"loss": total.detach(), **metrics,
                       "grad_norm": grad_norm}

    return step


def create_query_state(cfg: Config, seed: int = 1,
                       query_source: str = "video", steps_per_epoch: int = 1,
                       video_trunk: str = "conv", frame_hw=(48, 48),
                       device=None) -> TrainState:
    model = init_query_separator(cfg, query_source, video_trunk, frame_hw,
                                 torch.Generator().manual_seed(seed), device)
    return create_train_state(cfg, seed, steps_per_epoch, device,
                              model=model)


def make_query_eval_step(cfg: Config, query_source: str = "video"
                         ) -> Callable:
    """Query-conditioned inference + resynthesis + SI-SDR: the separation
    is driven by the modality query alone, scored like make_eval_step
    (mixture-phase iSTFT, live-channel PIT SI-SDR). step(model, feats) ->
    {pred_wavs, si_sdr, perm}."""

    def step(model: Separator, feats: dict):
        with torch.no_grad():
            queries, _ = _queries_and_logits(model, feats, cfg,
                                             query_source)
            out = model(feats["mix_feas"], cfg, queries=queries,
                        mix_ri=feats.get("mix_ri"))
            wavs = istft_cfg(out.pred.float() * _mixture_phasor(
                feats["mix_ri"])[:, None], cfg, length=cfg.max_len)
            scores, perm = si_sdr_pit(wavs, feats["source_wavs"],
                                      live=feats.get("channel_live"))
        return {"pred_wavs": wavs, "si_sdr": scores, "perm": perm}

    return step


def query_train_loop(cfg: Config, make_batch: Callable, seed: int = 1,
                     max_epochs: Optional[int] = None,
                     epoch_size: Optional[int] = None,
                     query_source: str = "video", video_trunk: str = "conv",
                     frame_hw=(48, 48), metrics_path: Optional[str] = None,
                     checkpoint_dir: Optional[str] = None,
                     resume: bool = False, dev_batch: Optional[dict] = None,
                     eval_every: int = 1, init_from: Optional[str] = None,
                     device=None):
    """Epoch loop of the audio-visual / image-query configurations.
    make_batch(generator) -> feats, drawn from the state's generator.
    Saves every cfg.checkpoint_every_epochs epochs and after the last.
    Returns (state, per-epoch dev SI-SDR list)."""
    epochs = max_epochs if max_epochs is not None else cfg.max_epoch
    esize = epoch_size if epoch_size is not None else cfg.epoch_size
    cfg = cfg.replace(max_epoch=epochs)
    state = create_query_state(cfg, seed, query_source, esize, video_trunk,
                               frame_hw, device)
    if init_from:
        # warm start into a fresh optimizer
        state = init_params_from(state, init_from, cfg=cfg)
    elif resume and checkpoint_dir and latest_step(checkpoint_dir) is not None:
        state = restore_checkpoint(checkpoint_dir, state)
    train_step = make_query_train_step(cfg, query_source, esize)
    eval_step = make_query_eval_step(cfg, query_source)
    writer = MetricsWriter(metrics_path)
    sdr_history = []
    metrics = {}
    saved_step = -1
    try:
        for epoch in range(state.step // max(esize, 1), epochs):
            for _ in range(esize):
                state, metrics = train_step(state,
                                            make_batch(state.generator))
            row = dict(metrics)
            if dev_batch is not None and eval_every \
                    and (epoch + 1) % eval_every == 0:
                sdr = float(eval_step(state.model,
                                      dev_batch)["si_sdr"].mean())
                sdr_history.append(sdr)
                row["si_sdr"] = sdr
            writer.write("epoch", state.step, epoch=epoch, **row)
            if checkpoint_dir and \
                    (epoch + 1) % cfg.checkpoint_every_epochs == 0:
                saved_step = save_checkpoint(checkpoint_dir, state, cfg=cfg)
        if checkpoint_dir and state.step != saved_step:
            save_checkpoint(checkpoint_dir, state, cfg=cfg)
    finally:
        writer.close()
    return state, sdr_history
