"""Target-speaker extraction with the life-long speaker memory (the port of
`dl4ss_tpu/train/memory_trainer.py`), the Cocktail / Multi_modal stack:

  * the query is a voiceprint (a BiLSTM + mean-pool over the target's
    clean speech, nnet.py:66-71), an image-CNN embedding (Multi_modal
    nnet.py:70-90) or a lip-frame embedding, by `query_source`;
  * the voiceprint is written into the memory INSIDE the graph (so the
    gradient flows through the write, extend_layers.py:132-216) and the
    mask-head query is the freshly written row; the rows it starts from
    are detached;
  * the persistent memory is then updated OUTSIDE the gradient step (the
    Keras `update_memory` after every train_on_batch, nnet.py:130-135);
  * at eval the clean input is unused and the memory row alone drives the
    mask; unknown speakers are `enroll`-ed first (predict.py:160-180);
  * training stops early on the per-epoch dev loss (patience 10) and keeps
    the best parameters and memory (nnet.py:149-172);
  * under cfg.dp_size > 1 each rank trains on its share of the batch and
    both writes sum over the global batch (models/memory.py); the dev loss
    is the global mean, so every rank takes the same early-stop decision.

The mask head is the additive `align` head whatever the preset's
`mask_head`, as in JAX; it has no kernel. The encoder takes the kernel
route under cfg.use_pallas_rnn (K7 / K8 for the `cocktail` preset's LSTM),
and so, on the card, do the query BiLSTMs (`models.query.query_rnn`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.models.attention import apply_mask_head, init_mask_head
from dl4ss_tpu_torch.models.encoder import apply_encoder, init_encoder
from dl4ss_tpu_torch.models.memory import (SLOT_IMAGE, SLOT_SPEECH,
                                           SLOT_VIDEO, MemorySlots,
                                           init_memory, memory_read,
                                           memory_rows, memory_write_slot)
from dl4ss_tpu_torch.parallel.mesh import (Mesh, mean_metrics, mesh_for_cfg,
                                           shard_batch, shard_state)
from dl4ss_tpu_torch.models.query import (apply_image_query,
                                          apply_speech_query,
                                          apply_video_query,
                                          init_image_query,
                                          init_speech_query,
                                          init_video_query)
from dl4ss_tpu_torch.train.metrics import MetricsWriter
from dl4ss_tpu_torch.train.state import AdamState, make_optimizer
from dl4ss_tpu_torch.train.steps import _backward_and_update
from dl4ss_tpu_torch.utils.profiling import span

# the log-spectral silence floor, MaskingGt(log(spacing(1) * 2))
# (nnet.py:43-47, extend_layers.py:231-251)
_LOG_FLOOR = float(np.log(np.spacing(1) * 2))


class MemoryModel(nn.Module):
    """encoder + align mask head + one query encoder (`speech_query`,
    `image_query` or `video_query`), named like the JAX pytree."""

    def __init__(self, cfg: Config, query_source: str = "speech",
                 frame_hw: Tuple[int, int] = (48, 48),
                 video_trunk: str = "conv", generator=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.encoder = init_encoder(cfg, generator, device)
        self.mask_head = init_mask_head(cfg.replace(mask_head="align"),
                                        generator, device)
        if query_source == "speech":
            self.speech_query = init_speech_query(cfg, generator, device)
        elif query_source == "image":
            self.image_query = init_image_query(cfg, generator=generator,
                                                device=device)
        elif query_source == "video":
            # lip-frame queries into the memory's video slot: the write path
            # the reference defines (MEMORY.add_video, main_run.py:142-171)
            self.video_query = init_video_query(
                cfg, frame_hw=frame_hw, trunk=video_trunk,
                generator=generator, device=device)
        else:
            raise ValueError(query_source)


def init_memory_model(cfg: Config, query_source: str = "speech",
                      frame_hw: Tuple[int, int] = (48, 48),
                      video_trunk: str = "conv", generator=None,
                      device=None) -> MemoryModel:
    return MemoryModel(cfg, query_source, frame_hw, video_trunk, generator,
                       device)


@dataclasses.dataclass
class MemoryTrainState:
    step: int
    model: MemoryModel
    opt_state: AdamState
    memory: MemorySlots
    generator: torch.Generator


def _valid_frames(clean: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Non-silent frame mask: Masking(mask_value=0) for linear features,
    MaskingGt(log(spacing(1)*2)) for log-spectral ones."""
    if cfg.log_spectral:
        return (clean > _LOG_FLOOR).any(dim=-1)
    return (clean != 0.0).any(dim=-1)


def _voiceprint(model: MemoryModel, feats: dict, cfg: Config,
                query_source: str) -> torch.Tensor:
    if query_source == "speech":
        clean = feats["clean_feas"]
        return apply_speech_query(model.speech_query, clean,
                                  _valid_frames(clean, cfg),
                                  cfg.use_pallas_rnn)
    if query_source == "video":
        # (B, T, H, W, 3) lip frames -> (B, E); the logits are unused here
        return apply_video_query(model.video_query, feats["query_video"],
                                 cfg.use_pallas_rnn)[1]
    return apply_image_query(model.image_query, feats["query_image"])


def _slot(query_source: str) -> int:
    return {"speech": SLOT_SPEECH, "image": SLOT_IMAGE,
            "video": SLOT_VIDEO}[query_source]


def _memory_loss(pred, masks, feats, cfg: Config) -> torch.Tensor:
    """The spectral mask MSE of the Keras stack (nnet.py:113), or under
    cfg.loss_mode='si_sdr' the negative SI-SDR of the designated target
    after the mixture-phase iSTFT (the plain one, as JAX's istft_cfg): no
    PIT, the protocol designates the target (prepare_data.py:104-155)."""
    if cfg.loss_mode == "si_sdr":
        from dl4ss_tpu_torch.eval.sisdr import si_sdr
        from dl4ss_tpu_torch.ops.crm import unpack_ri
        from dl4ss_tpu_torch.ops.stft import istft_cfg
        pred_spec = masks[:, 0].to(torch.complex64) * unpack_ri(
            feats["mix_ri"])
        wav = istft_cfg(pred_spec, cfg, length=cfg.max_len)
        return -si_sdr(wav, feats["target_wav"]).mean()
    return ((pred - feats["target_mag"]) ** 2).mean()


def memory_batch(generator: torch.Generator, bank: torch.Tensor,
                 cfg: Config, query_key: Optional[str] = None,
                 query_bank: Optional[torch.Tensor] = None) -> dict:
    """One training batch of the memory mode (the JAX CLI's `make_batch`):
    mixtures drawn from `bank` by `generator`, their features, the LINEAR
    mixture and target magnitudes, the target (the first speaker) and its
    clean features; with a query bank ((S, V, ...) images or clips), one
    of the target speaker's entries under `query_key`, also drawn from
    `generator`."""
    from dl4ss_tpu_torch.data.synth import (featurize, linear_target_mags,
                                            sample_mixtures)
    b = sample_mixtures(generator, bank, cfg)
    f = featurize(b, cfg)
    mix_mag, target_mag = linear_target_mags(f, b, cfg)
    feats = {"mix_feas": f["mix_feas"], "mix_mag": mix_mag,
             "spk_id": b.spk_idx[:, 0], "clean_feas": f["src_feas"][:, 0],
             "target_mag": target_mag,
             # loss_mode='si_sdr' resynthesises through the mixture spectrum
             # and scores against the designated target wav
             "mix_ri": f["mix_ri"], "target_wav": b.source_wavs[:, 0]}
    if query_bank is not None:
        vi = torch.randint(0, query_bank.shape[1], b.spk_idx[:, 0].shape,
                           generator=generator).to(bank.device)
        feats[query_key] = query_bank[b.spk_idx[:, 0], vi]
    return feats


def _extract(model: MemoryModel, memory: MemorySlots, feats: dict,
             cfg: Config, slot: int, spk_id: torch.Tensor):
    emb_map, _ = apply_encoder(model.encoder, feats["mix_feas"], cfg)
    query = memory_read(memory, spk_id, slot)                 # (B, E)
    with span("align_head"):
        masks = apply_mask_head(model.mask_head, emb_map, query[:, None, :],
                                cfg.replace(mask_head="align"))
    return masks, masks[:, 0] * feats["mix_mag"]


def make_memory_train_step(cfg: Config, query_source: str = "speech",
                           steps_per_epoch: int = 1,
                           mesh: Optional[Mesh] = None) -> Callable:
    """step(state, feats) -> (state, {loss, grad_norm}), updating the model,
    the optimizer state and the memory in place. feats: mix_feas, mix_mag,
    spk_id (B,), target_mag and clean_feas / query_image / query_video
    (mix_ri and target_wav under loss_mode='si_sdr'); with a `mesh`, this
    rank's rows of the global batch."""
    opt = make_optimizer(cfg, steps_per_epoch)
    slot = _slot(query_source)

    def step(state: MemoryTrainState, feats: dict):
        with span("forward"):
            spk_id = feats["spk_id"]
            vp = _voiceprint(state.model, feats, cfg, query_source)
            # the differentiable in-graph write + select (the Keras graph
            # path)
            old = MemorySlots(state.memory.vectors.detach(),
                              state.memory.age)
            with span("memory_write"):
                mem = memory_write_slot(old, spk_id, vp, slot, mesh=mesh)
            masks, pred = _extract(state.model, mem, feats, cfg, slot,
                                   spk_id)
            loss = _memory_loss(pred, masks, feats, cfg)
        grad_norm = _backward_and_update(list(state.model.parameters()),
                                         state.opt_state, opt, loss, mesh)
        # the out-of-graph persistent update (update_memory semantics)
        with span("memory_write"):
            state.memory = memory_write_slot(state.memory, spk_id,
                                             vp.detach(), slot, mesh=mesh)
        state.step += 1
        return state, mean_metrics({"loss": loss.detach(),
                                    "grad_norm": grad_norm}, mesh)

    return step


def make_memory_eval_step(cfg: Config, query_source: str = "speech"
                          ) -> Callable:
    """Inference: the memory row drives the mask (predict.py:231-245).
    step(model, memory, feats) -> {pred_mag, mask, loss}: the dev loss is
    the MSE, or the negative SI-SDR under loss_mode='si_sdr', so early
    stopping selects on the trained objective."""
    slot = _slot(query_source)

    def step(model: MemoryModel, memory: MemorySlots, feats: dict):
        with torch.no_grad():
            masks, pred = _extract(model, memory, feats, cfg, slot,
                                   feats["spk_id"])
            loss = _memory_loss(pred, masks, feats, cfg)
        return {"pred_mag": pred, "mask": masks[:, 0], "loss": loss}

    return step


def enroll(model: MemoryModel, memory: MemorySlots, cfg: Config,
           spk_id: torch.Tensor, enroll_feats: torch.Tensor,
           query_source: str = "speech") -> MemorySlots:
    """Unknown-speaker enrollment (predict.py:160-180): run the speaker's
    clean audio (or frames / images) through the query branch and write
    the result into their memory row."""
    with torch.no_grad():
        if query_source == "speech":
            vp = apply_speech_query(model.speech_query, enroll_feats,
                                    _valid_frames(enroll_feats, cfg),
                                    cfg.use_pallas_rnn)
        elif query_source == "video":
            vp = apply_video_query(model.video_query, enroll_feats,
                                   cfg.use_pallas_rnn)[1]
        else:
            vp = apply_image_query(model.image_query, enroll_feats)
        return memory_write_slot(memory, spk_id, vp, _slot(query_source))


def unk_row(cfg: Config) -> int:
    """The reserved unknown-speaker memory row, appended after the known
    speakers (only when cfg.unk_spk)."""
    if not cfg.unk_spk:
        raise ValueError("cfg.unk_spk is False: no unk row is reserved")
    return cfg.num_speakers


def create_memory_state(cfg: Config, seed: int = 1,
                        query_source: str = "speech",
                        steps_per_epoch: int = 1,
                        frame_hw: Tuple[int, int] = (48, 48),
                        video_trunk: str = "conv", device=None
                        ) -> MemoryTrainState:
    """A fresh state: the model from `seed`, zero moments, zero memory of
    memory_rows(cfg) rows (the voiceprint is 2 * (E // 2) wide from the
    BiLSTM concat; image and video queries are E wide), step 0 and the
    batch generator seeded from seed + 1."""
    device = resolve_device(device)
    model = init_memory_model(cfg, query_source, frame_hw, video_trunk,
                              torch.Generator().manual_seed(seed), device)
    opt = make_optimizer(cfg, steps_per_epoch)
    dim = (2 * max(cfg.embedding_size // 2, 1) if query_source == "speech"
           else cfg.embedding_size)
    return MemoryTrainState(
        step=0, model=model, opt_state=opt.init(list(model.parameters())),
        memory=init_memory(memory_rows(cfg), dim, device),
        generator=torch.Generator().manual_seed(seed + 1))


def _snapshot(state: MemoryTrainState):
    """Copies of the parameters and the memory: the optimizer updates the
    parameters in place, so references would follow them."""
    return ({k: v.detach().clone() for k, v in
             state.model.state_dict().items()},
            MemorySlots(state.memory.vectors.clone(),
                        state.memory.age.clone()))


def memory_train_loop(cfg: Config, make_batch: Callable, seed: int = 1,
                      max_epochs: Optional[int] = None,
                      epoch_size: Optional[int] = None,
                      query_source: str = "speech", patience: int = 10,
                      dev_batch: Optional[dict] = None,
                      init_state: Optional[MemoryTrainState] = None,
                      frame_hw: Tuple[int, int] = (48, 48),
                      video_trunk: str = "conv",
                      metrics_path: Optional[str] = None, device=None):
    """Early-stopped training (nnet.py:149-172): per-epoch dev loss, stop
    after `patience` epochs without improvement, return the best params
    and memory. make_batch(generator) -> feats dict, drawn from the
    state's generator. `init_state` goes on from a restored state; its
    step counts toward the epoch budget. Under cfg.dp_size / mp_size each
    rank trains on its rows of every batch (`mesh_for_cfg`); the returned
    state is the same on every rank. Returns (state, dev losses)."""
    epochs = max_epochs if max_epochs is not None else cfg.max_epoch
    esize = epoch_size if epoch_size is not None else cfg.epoch_size
    # horizon-aware schedules see the real epoch budget
    cfg = cfg.replace(max_epoch=epochs)
    mesh = mesh_for_cfg(cfg, device)
    state = (init_state if init_state is not None else
             create_memory_state(cfg, seed, query_source, esize, frame_hw,
                                 video_trunk, device))
    if mesh is not None:
        state = shard_state(state, mesh)
        dev_batch = shard_batch(dev_batch, mesh)
    train_step = make_memory_train_step(cfg, query_source, esize, mesh)
    eval_step = make_memory_eval_step(cfg, query_source)
    main = mesh is None or mesh.is_main
    writer = MetricsWriter(metrics_path if main else None, echo=False)
    best_loss, best = float("inf"), None
    bad_epochs = 0
    history = []
    last = {"loss": float("nan")}
    try:
        for epoch in range(state.step // max(esize, 1), epochs):
            for _ in range(esize):
                state, last = train_step(state, shard_batch(
                    make_batch(state.generator), mesh))
            if dev_batch is None:
                continue
            dev = eval_step(state.model, state.memory, dev_batch)["loss"]
            # the global batch's loss: every rank stops on the same epoch
            dev = float(dev if mesh is None else mesh.data_mean(dev))
            history.append(dev)
            writer.write("epoch", state.step, epoch=epoch, dev_loss=dev,
                         train_loss=float(last["loss"]))
            if dev < best_loss:
                best_loss, best = dev, _snapshot(state)
                bad_epochs = 0
            else:
                bad_epochs += 1
                if bad_epochs >= patience:
                    break
    finally:
        writer.close()
    if best is not None:
        state.model.load_state_dict(best[0])
        state.memory = best[1]
    return state, history
