"""Mixture synthesis and featurization (the port of `dl4ss_tpu/data/synth.py`).

The reference's generator inner loop (Torch_multi/predata_multiAims.py:
122-214): crop -> mean-subtract -> peak-normalize -> optional random
circular shift -> per-channel dB gain -> sum into the mixture. The
utterance bank lives on the model's device and every batch is drawn there
by gathers; the random draws come from a `torch.Generator` on the CPU
(jax.random streams cannot be reproduced in torch), so one seed gives the
same batches on every device. The synthetic "speech-like" bank is numpy,
bit-identical to the JAX package's for one seed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.ops.stft import spectral_feature_cfg, stft_cfg
from dl4ss_tpu_torch.utils.profiling import span


class MixtureBatch(NamedTuple):
    mix_wav: torch.Tensor      # (B, N)
    source_wavs: torch.Tensor  # (B, K, N) gain-scaled sources (sum == mix)
    spk_idx: torch.Tensor      # (B, K) int64 speaker ids
    gains: torch.Tensor        # (B, K) linear per-channel gains
    utt_idx: Optional[torch.Tensor] = None  # (B, K) per-speaker utterance row


def normalize_utterance(wav: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """mean-subtract then peak-normalize (predata_multiAims.py:150-151)."""
    wav = wav - wav.mean(dim=-1, keepdim=True)
    peak = wav.abs().amax(dim=-1, keepdim=True)
    return wav / torch.clamp(peak, min=eps)


def make_synthetic_bank(seed: int, num_speakers: int, utts_per_speaker: int,
                        num_samples: int, rate: int = 8000,
                        timbre: bool = False) -> np.ndarray:
    """(S, U, N) float32 bank of harmonic speech-like utterances: a
    per-speaker f0 with +/-4% per-utterance jitter, 8 harmonics, vibrato and
    an AM envelope. timbre=True also fixes a per-speaker harmonic amplitude
    envelope (with +/-8% per-utterance shimmer), which makes speaker
    identity learnable across utterances: the rehearsal corpus uses it. The
    same numpy draws, in the same order, as the JAX package's, so one seed
    gives a bit-identical bank."""
    rng = np.random.default_rng(seed)
    t = np.arange(num_samples) / rate
    f0s = rng.uniform(80.0, 280.0, num_speakers)
    # log-uniform over [0.02, 1]: wide per-speaker spectral contrast
    prof = (np.exp(rng.uniform(np.log(0.02), 0.0, (num_speakers, 8)))
            if timbre else None)
    bank = np.zeros((num_speakers, utts_per_speaker, num_samples), np.float32)
    for s in range(num_speakers):
        for u in range(utts_per_speaker):
            f0 = f0s[s] * (1.0 + 0.04 * rng.standard_normal())
            sig = np.zeros_like(t)
            for h in range(1, 9):
                if timbre:
                    amp = (prof[s, h - 1]
                           * (1.0 + 0.08 * rng.standard_normal()) / h)
                else:
                    amp = rng.uniform(0.2, 1.0) / h
                vib = 1.0 + 0.01 * np.sin(2 * np.pi * rng.uniform(2, 6) * t)
                sig += amp * np.sin(2 * np.pi * h * f0 * vib * t
                                    + rng.uniform(0, 2 * np.pi))
            env = 0.55 + 0.45 * np.sin(
                2 * np.pi * rng.uniform(1.0, 3.0) * t + rng.uniform(0, 6.28))
            sig = sig * env + 0.01 * rng.standard_normal(num_samples)
            bank[s, u] = (sig / np.max(np.abs(sig))).astype(np.float32)
    return bank


def _roll_rows(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Circularly shift each row of x (..., N) right by its own shift
    (`jnp.roll` per row): out[i] = x[(i - shift) mod N]."""
    n = x.shape[-1]
    idx = (torch.arange(n, device=x.device) - shifts[..., None]) % n
    return torch.gather(x, -1, idx)


def sample_mixtures(generator: torch.Generator, bank: torch.Tensor,
                    cfg: Config, batch_size: Optional[int] = None,
                    train: bool = True,
                    noise_bank: Optional[torch.Tensor] = None
                    ) -> MixtureBatch:
    """Draw a batch of k-speaker mixtures from an (S, U, N) utterance bank.

    k is fixed (= cfg.max_mix); mixtures with fewer live speakers have zero
    gains when min_mix < max_mix. Speakers within an item are distinct.
    With train and cfg.augment_data: random circular shifts and, when
    cfg.db_range > 0, the SNR gains: k=2 scales one channel by
    10^(dB/20*r) (predata_multiAims_dB.py:123-130), k=3 the
    normal/large/small trio (predata_multiAims_3dB.py:132-145). The
    street-noise add (cfg.add_bgd_noise with a noise bank) goes into the
    mixture only.
    """
    with span("sample"):
        b = batch_size or cfg.batch_size
        k = cfg.max_mix
        s, u, n = bank.shape
        dev = bank.device
        g = generator

        def ints(lo, hi, shape):
            return torch.randint(lo, hi, shape, generator=g).to(dev)

        spk_idx = torch.rand((b, s), generator=g).argsort(dim=1)[:, :k].to(dev)
        utt_idx = ints(0, u, (b, k))
        wavs = normalize_utterance(bank[spk_idx, utt_idx])          # (B, K, N)
        if train and cfg.augment_data:
            wavs = _roll_rows(wavs, ints(0, n, (b, k)))

        if cfg.min_mix < cfg.max_mix:
            live = ints(cfg.min_mix, cfg.max_mix + 1, (b,))
        else:
            live = torch.full((b,), cfg.max_mix, device=dev)

        gains = torch.ones((b, k), device=dev)
        if cfg.db_range > 0 and train and cfg.augment_data:
            scale = cfg.db_range / 20.0
            r_db = torch.rand((b, 3), generator=g).to(dev)
            chan = ints(0, min(k, 2), (b,))
            gains2 = gains.clone()
            gains2[torch.arange(b, device=dev), chan] = 10.0 ** (
                scale * r_db[:, 0])
            if k >= 3:
                gains3 = gains.clone()
                # the normal, large and small channels
                gains3[:, 0] = 10.0 ** (scale * 0.5)
                gains3[:, 1] = 10.0 ** (scale * (0.5 + 0.5 * r_db[:, 1]))
                gains3[:, 2] = 10.0 ** (scale * (0.5 * r_db[:, 2]))
                gains = torch.where((live == 3)[:, None], gains3, gains)
            gains = torch.where((live == 2)[:, None], gains2, gains)
        lane = torch.arange(k, device=dev)[None, :] < live[:, None]
        gains = gains * lane.to(gains.dtype)

        sources = wavs * gains[..., None]
        mix = sources.sum(dim=1)
        if cfg.add_bgd_noise and noise_bank is not None:
            nidx = ints(0, noise_bank.shape[0], (b,))
            nshift = ints(0, noise_bank.shape[1], (b,))
            mix = mix + cfg.bgd_noise_ratio * _roll_rows(
                noise_bank[nidx][:, :n], nshift)
        return MixtureBatch(mix_wav=mix, source_wavs=sources, spk_idx=spk_idx,
                            gains=gains, utt_idx=utt_idx)


def add_noise_to_mix(generator: torch.Generator, batch: MixtureBatch,
                     noise_bank: torch.Tensor, cfg: Config) -> MixtureBatch:
    """Eval-time background noise: cfg.bgd_noise_ratio (0.3) times a random
    noise wav, circularly shifted by a random amount, added to the MIXTURE
    only; the clean sources stay the scoring references (Cocktail
    predict.py:152-158; predata_multiAims_noisedB.py:198-222). The noise
    row and shift of each item come from `generator`."""
    b, n = batch.mix_wav.shape
    dev = batch.mix_wav.device
    nidx = torch.randint(0, noise_bank.shape[0], (b,),
                         generator=generator).to(dev)
    nshift = torch.randint(0, noise_bank.shape[1], (b,),
                           generator=generator).to(dev)
    noise = _roll_rows(noise_bank[nidx][:, :n], nshift)
    return batch._replace(mix_wav=batch.mix_wav + cfg.bgd_noise_ratio * noise)


def featurize(batch: MixtureBatch, cfg: Config) -> dict:
    """Batch -> features, the reference batch-dict keys
    (predata_multiAims.py:229-239): mix magnitude features, the mixture's
    packed spectrum (B, T, F, 2), per-source clean features. Under
    cfg.use_pallas_stft (hann, centered, L % hop == 0, linear features)
    the STFT feature kernel (K1) runs on the mixture and on the B*K
    sources, as in JAX; otherwise the plain STFT.
    """
    with span("featurize"):
        b, k, n = batch.source_wavs.shape
        if (cfg.use_pallas_stft and not cfg.log_spectral
                and cfg.window == "hann" and cfg.center
                and cfg.frame_length % cfg.frame_shift == 0):
            from dl4ss_tpu_torch.ops.stft_kernels import stft_features
            mix_feat, re, im = stft_features(batch.mix_wav, cfg.frame_length,
                                             cfg.frame_shift)
            mix_ri = torch.stack([re, im], dim=-1)
            src_feat, sre, sim = stft_features(
                batch.source_wavs.reshape(b * k, n), cfg.frame_length,
                cfg.frame_shift)
            src_feat = src_feat.reshape(b, k, *src_feat.shape[1:])
            src_re, src_im = (x.reshape(src_feat.shape) for x in (sre, sim))
        else:
            mix_feat, mix_spec = spectral_feature_cfg(batch.mix_wav, cfg)
            mix_ri = torch.stack([mix_spec.real, mix_spec.imag], dim=-1)
            src_spec = stft_cfg(batch.source_wavs, cfg)
            src_feat = src_spec.abs()
            src_re, src_im = src_spec.real, src_spec.imag
        out = {
            "mix_wav": batch.mix_wav,
            "mix_feas": mix_feat,                       # (B, T, F)
            "mix_ri": mix_ri,                           # (B, T, F, 2)
            "spk_idx": batch.spk_idx,                   # (B, K)
            "channel_live": batch.gains > 0,            # (B, K)
            "source_wavs": batch.source_wavs,           # (B, K, N)
        }
        if cfg.is_complex_mask:
            out["src_ri"] = torch.stack([src_re, src_im], dim=-1)  # B,K,T,F,2
        out["src_feas"] = src_feat                      # (B, K, T, F)
        return out


def same_speaker_real_specs(generator: torch.Generator, batch: MixtureBatch,
                            bank: torch.Tensor, cfg: Config,
                            offsets: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """dis-sp "real" pool: for each mixed speaker, the clean magnitude
    spectrogram of a DIFFERENT utterance of the same speaker
    (predata_fromList_dis.py:37-66, consumed by main_run_sstune_dis_sp).
    The utterance is the mixed one's row plus an offset in [1, U-1], so the
    mixed utterance itself is never the "real" sample; `offsets` (B, K)
    gives them, else they are drawn from `generator`. With one utterance
    per speaker (or no utterance rows) a row is drawn at random. The plain
    STFT, as in JAX. Returns (B, K, T, F) for feats["real_specs"]."""
    b, k = batch.spk_idx.shape
    u = bank.shape[1]
    dev = bank.device
    if batch.utt_idx is not None and u > 1:
        if offsets is None:
            offsets = torch.randint(1, u, (b, k), generator=generator)
        utt = (batch.utt_idx + offsets.to(dev)) % u
    else:
        utt = torch.randint(0, u, (b, k), generator=generator).to(dev)
    wavs = normalize_utterance(bank[batch.spk_idx, utt])
    return stft_cfg(wavs, cfg).abs()


def linear_target_mags(feats: dict, batch: MixtureBatch, cfg: Config):
    """(mix_mag, target_mag) for the memory trainer: the mask's
    multiplicand and the loss target are LINEAR spectra even when the
    network's input features are log-domain (output = mask (.) mixture
    spectrum, Cocktail nnet.py:95, predict.py:241-245). The target is the
    first speaker (the Cocktail first-speaker-is-target convention)."""
    if not cfg.log_spectral:
        return feats["mix_feas"], feats["src_feas"][:, 0]
    ri = feats["mix_ri"]
    mix_mag = torch.complex(ri[..., 0], ri[..., 1]).abs()
    return mix_mag, stft_cfg(batch.source_wavs[:, 0], cfg).abs()
