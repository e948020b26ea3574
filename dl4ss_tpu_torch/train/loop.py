"""The epoch/batch training loop (the port of `dl4ss_tpu/train/loop.py`),
the joint, dense, adversarial and classifier modes from an utterance bank
or from the wsj0-mix lists.

Mirrors the reference main loops (MAX_EPOCH x EPOCH_SIZE with periodic
checkpointing and a per-epoch SDR, Torch_multi/main_run.py:453-527,
main_run_multi_selfSS.py:458-463): each step samples and featurizes a
batch from the device-resident bank (or takes the next list batch) and
trains on it; each `eval_every` epochs a held-out batch (no augmentation)
is scored by SI-SDR, and with cfg.out_sep_result its separated wavs are
written under cfg.output_dir (Out_Sep_Result, main_run.py:515-516); every
cfg.checkpoint_every_epochs epochs, and after the last, the state is saved
under `checkpoint_dir`.

Under cfg.dp_size / mp_size (`parallel.mesh.mesh_for_cfg`) every rank
holds the banks and draws every global batch from the same generator,
then featurizes and trains on its own rows; the held-out SI-SDR is the
global mean; rank 0 alone writes checkpoints (the file a single-device run
writes) and metrics, while the others wait at a barrier.
"""

from __future__ import annotations

from typing import Optional

import torch

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.data.listsampler import list_same_speaker_real_specs
from dl4ss_tpu_torch.data.synth import (featurize, make_synthetic_bank,
                                        same_speaker_real_specs,
                                        sample_mixtures)
from dl4ss_tpu_torch.eval.wav_export import export_batch_outputs
from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.parallel.mesh import (describe_layout, mesh_for_cfg,
                                           save_on_main, shard_batch,
                                           shard_state, unshard_state)
from dl4ss_tpu_torch.train.checkpoint import (init_params_from, latest_step,
                                              restore_checkpoint,
                                              save_checkpoint)
from dl4ss_tpu_torch.train.metrics import MetricsWriter
from dl4ss_tpu_torch.train.state import create_train_state
from dl4ss_tpu_torch.train.steps import (make_adversarial_step,
                                         make_classifier_step,
                                         make_dense_train_step,
                                         make_eval_step, make_fused_step,
                                         make_train_step)


def train_loop(cfg: Config, bank: Optional[torch.Tensor] = None,
               max_epochs: Optional[int] = None,
               epoch_size: Optional[int] = None,
               seed: int = 1,
               mode: str = "joint",
               metrics_path: Optional[str] = None,
               checkpoint_dir: Optional[str] = None,
               resume: bool = False,
               eval_every: int = 1,
               init_from: Optional[str] = None,
               dis_sp: bool = False,
               noise_bank: Optional[torch.Tensor] = None,
               sampler=None,
               eval_batch=None,
               device=None):
    """Train on `device` (default `cuda`; raises without a GPU unless
    device='cpu'). mode: joint | dense | adversarial | classifier.
    `bank` (S, U, N) defaults to the synthetic bank of 4 utterances per
    speaker from `seed`. One seed drives the bank, the init and the
    sampling (main_run.py:21-23).

    `checkpoint_dir` saves the state there; with `resume` the run goes on
    from its latest step, if it holds one. `init_from` warm-starts from
    another run's parameters with a fresh optimizer (fine-tuning). `dis_sp`
    feeds the adversarial discriminator same-speaker different-utterance
    spectra (B10) instead of the clean targets (B9). `noise_bank` (W, N)
    adds the street noise to every training mixture (A5; bank mode).

    `sampler` (a `Wsj0MixSampler` on `device`) switches to the official
    list recipe: each epoch is one shuffled pass over the mixture lists,
    num_batches(batch_size) steps (the reference's `yield False` loop,
    TDAA_beta/predata_fromList.py:80-233 feeding main_run_sstune*.py), in
    the order of numpy's default_rng(seed + 7919 * (epoch + 1)), with the
    circular-shift augment under cfg.augment_data; dis-sp draws its real
    pool from the list vocabulary. `eval_batch` is the held-out MixtureBatch
    scored each epoch (default: the first unshuffled list batch).

    Returns (final state, list of per-epoch mean SI-SDR): under a mesh the
    same on every rank, with any row-sharded table whole again."""
    if mode not in ("joint", "dense", "adversarial", "classifier"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "adversarial" and not cfg.use_discriminator:
        raise ValueError("adversarial mode needs cfg.use_discriminator")
    if dis_sp and mode != "adversarial":
        raise ValueError("--dis-sp only applies to adversarial mode")
    device = resolve_device(device)
    mesh = mesh_for_cfg(cfg, device)
    epochs = max_epochs if max_epochs is not None else cfg.max_epoch
    # horizon-aware schedules (cosine) see the real epoch budget
    cfg = cfg.replace(max_epoch=epochs)
    if sampler is not None:
        epoch_size = sampler.num_batches(cfg.batch_size)
        if epoch_size == 0:
            raise ValueError(
                f"every mixture-list pool has fewer than batch_size="
                f"{cfg.batch_size} entries ({len(sampler.entries)} total): "
                f"no full batch can be formed; lower batch_size or extend "
                f"the lists (floor-division batch semantics, "
                f"predata_fromList.py:90)")
    else:
        epoch_size = (epoch_size if epoch_size is not None
                      else cfg.epoch_size)
    if bank is None and sampler is None:
        bank = torch.as_tensor(make_synthetic_bank(
            seed, cfg.num_speakers, 4, cfg.max_len), device=device)
    state = create_train_state(cfg, seed, epoch_size, device)
    if init_from:
        # warm start: donor weights, fresh optimizer and schedule (the
        # objective may have changed, so --resume's exact restore does not
        # apply)
        state = init_params_from(state, init_from, cfg=cfg)
    if resume and checkpoint_dir and latest_step(checkpoint_dir) is not None:
        state = restore_checkpoint(checkpoint_dir, state)
    main = mesh is None or mesh.is_main
    if mesh is not None:
        state = shard_state(state, mesh)
        if main:
            print(describe_layout(mesh, state.model))
    if sampler is not None:
        step_fn = {"joint": make_train_step,
                   "dense": make_dense_train_step,
                   "adversarial": make_adversarial_step,
                   "classifier": make_classifier_step}[mode](
                       cfg, epoch_size, mesh)
        if dis_sp:
            sp_rows, sp_counts = sampler.spk_tables()

        def run_epoch(state, epoch):
            last = {}
            # the same-speaker draws of an epoch come from its own seed, so
            # a resumed run draws what the unbroken one does
            gen = torch.Generator().manual_seed(
                seed + 104729 + 1_000_003 * epoch)
            for batch in sampler.batches(cfg.batch_size, shuffle=True,
                                         seed=seed + 7919 * (epoch + 1),
                                         augment=cfg.augment_data):
                feats = featurize(shard_batch(batch, mesh), cfg)
                if dis_sp:
                    feats["real_specs"] = shard_batch(
                        list_same_speaker_real_specs(
                            gen, batch, sampler.device_bank(), sp_rows,
                            sp_counts, cfg), mesh)
                state, last = step_fn(state, feats)
            return state, last

        if eval_batch is None and eval_every:
            eval_batch = next(sampler.batches(cfg.batch_size, shuffle=False))

        def held_out(state):
            return eval_batch
    else:
        if mode == "joint":
            run_one = make_fused_step(cfg, epoch_size,
                                      noise_bank=noise_bank, mesh=mesh)
        else:
            step_fn = {"dense": make_dense_train_step,
                       "adversarial": make_adversarial_step,
                       "classifier": make_classifier_step}[mode](
                           cfg, epoch_size, mesh)

            def run_one(state, bank):
                batch = sample_mixtures(state.generator, bank, cfg,
                                        noise_bank=noise_bank)
                feats = featurize(shard_batch(batch, mesh), cfg)
                if dis_sp:
                    # drawn for the global batch: the generator advances
                    # as in a single-device run
                    feats["real_specs"] = shard_batch(
                        same_speaker_real_specs(state.generator, batch,
                                                bank, cfg), mesh)
                return step_fn(state, feats)

        def run_epoch(state, epoch):
            last = {}
            for _ in range(epoch_size):
                state, last = run_one(state, bank)
            return state, last

        def held_out(state):
            return sample_mixtures(state.generator, bank, cfg, train=False)

    eval_step = make_eval_step(cfg)
    writer = MetricsWriter(metrics_path if main else None, echo=main)

    def save(state):
        save_checkpoint(checkpoint_dir, state, cfg=cfg)

    sdr_history = []
    start_epoch = state.step // max(epoch_size, 1)
    try:
        for epoch in range(start_epoch, epochs):
            state, last = run_epoch(state, epoch)
            record = dict(epoch=epoch, **last)
            if eval_every and (epoch + 1) % eval_every == 0:
                batch = held_out(state)
                ev = eval_step(state.model,
                               featurize(shard_batch(batch, mesh), cfg))
                sdr = ev["si_sdr"].mean()
                sdr = float(sdr if mesh is None else mesh.data_mean(sdr))
                sdr_history.append(sdr)
                record["si_sdr"] = sdr
                if cfg.out_sep_result:
                    # the per-epoch separated wavs under the batch_output
                    # contract (Out_Sep_Result, main_run.py:515-516)
                    wavs = ev["pred_wavs"]
                    wavs = wavs if mesh is None else mesh.gather(wavs)
                    names = [[f"spk{s:03d}" for s in row]
                             for row in batch.spk_idx.tolist()]
                    if main:
                        export_batch_outputs(
                            cfg.output_dir, batch.mix_wav.cpu().numpy(),
                            wavs.cpu().numpy(),
                            batch.source_wavs.cpu().numpy(), names,
                            cfg.frame_rate)
            writer.write("epoch", state.step, **record)
            if checkpoint_dir and ((epoch + 1) % cfg.checkpoint_every_epochs
                                   == 0 or epoch + 1 == epochs):
                save_on_main(mesh, state, save)
    finally:
        writer.close()
    return unshard_state(state, mesh), sdr_history

