"""List-driven mixtures, the official wsj0-2mix recipe (the port of
`dl4ss_tpu/data/listsampler.py`).

TDAA's epoch-finite list pipeline (TDAA_beta/predata_fromList.py:80-233,
predata_fromList_123.py per-k pools): mixtures come from the official
`mix_{k}_spk_{tr,cv,tt}.txt` lists with per-utterance dB gains (linear gain
10^(dB/20), :158-159), an epoch ends when the lists are exhausted (the
reference's `yield False`), and SHUFFLE_BATCH shuffles the entry order.

The host decodes every utterance the lists name once, into one bank that
goes to the device once; a batch is then a gather and a mix on the device
(`mix_from_list`), and an epoch is a walk over numpy index arrays, the same
arrays as the JAX sampler's for one seed. The random circular shift and the
same-speaker draw come from a `torch.Generator` (jax.random streams cannot
be reproduced in torch).
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.data.dirtree import _load_bank
from dl4ss_tpu_torch.data.synth import (MixtureBatch, _roll_rows,
                                        normalize_utterance)
from dl4ss_tpu_torch.data.wsj0mix import (Wsj0MixEntry, mix_list_name,
                                          parse_mix_list)
from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.ops.stft import stft_cfg


def mix_from_list(bank: torch.Tensor, utt_idx: torch.Tensor,
                  gains_db: torch.Tensor, spk_idx: torch.Tensor, cfg: Config,
                  live: Optional[torch.Tensor] = None,
                  shifts: Optional[torch.Tensor] = None) -> MixtureBatch:
    """bank (U, N); utt_idx / gains_db / spk_idx (B, K) -> MixtureBatch, on
    the bank's device.

    The reference's order: crop (bank rows are already MAX_LEN) ->
    mean-sub -> peak-norm -> pad -> per-utterance gain
    (predata_fromList.py:140-176). `live` (B, K) in {0, 1} gates the padded
    channels of entries with fewer than K speakers (the mixed-k recipe,
    predata_fromList_123.py:45-110). `shifts` (B, K), when given, rolls
    every source circularly right by that many samples: the AUGMENT_DATA
    train-time shift (predata_fromList.py:150-152), applied to the padded
    row (identical whenever the utterance fills MAX_LEN)."""
    wavs = normalize_utterance(bank[utt_idx])            # (B, K, N)
    if shifts is not None:
        wavs = _roll_rows(wavs, shifts)
    gains = torch.pow(10.0, gains_db / 20.0)
    if live is not None:
        gains = gains * live.to(gains.dtype)
    sources = wavs * gains[..., None]
    return MixtureBatch(mix_wav=sources.sum(dim=1), source_wavs=sources,
                        spk_idx=spk_idx, gains=gains, utt_idx=utt_idx)


def draw_same_speaker_rows(spk_idx: torch.Tensor, utt_idx: torch.Tensor,
                           spk_rows: torch.Tensor, spk_counts: torch.Tensor,
                           r: torch.Tensor) -> torch.Tensor:
    """For each (batch, channel) speaker, a bank row of a DIFFERENT
    utterance of the same speaker: the dis-sp real-pool draw from the list
    vocabulary (predata_fromList_dis.py:37-66). `spk_rows` (S, Umax) holds
    each speaker's bank rows (padded by repetition), `spk_counts` (S,) how
    many are live; `r` (B, K) are draws in [0, 2^30) (`speaker_draws`).
    Row r mod count; a collision with the mixed utterance steps to the next
    row. A speaker with one utterance gives that utterance."""
    counts = spk_counts[spk_idx]                          # (B, K)
    # a speaker of no list entry (count 0) is only ever a dead channel
    r = r % counts.clamp(min=1)
    drawn = spk_rows[spk_idx, r]
    bumped = spk_rows[spk_idx, (r + 1) % counts.clamp(min=1)]
    return torch.where((drawn == utt_idx) & (counts > 1), bumped, drawn)


def speaker_draws(generator: torch.Generator, shape) -> torch.Tensor:
    """The raw draws of `draw_same_speaker_rows`, on the CPU."""
    return torch.randint(0, 1 << 30, tuple(shape), generator=generator)


def list_same_speaker_real_specs(generator: torch.Generator,
                                 batch: MixtureBatch, bank: torch.Tensor,
                                 spk_rows: torch.Tensor,
                                 spk_counts: torch.Tensor, cfg: Config,
                                 r: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """dis-sp "real" pool for list-driven training: the clean magnitude
    spectra (B, K, T, F) of other utterances of the mixed speakers, drawn
    from the list vocabulary's utterances (predata_fromList_dis.py:37-66,
    consumed by main_run_sstune_dis_sp.py:613-624), with the same |STFT| as
    featurize's src_feas (the plain STFT, as in JAX). The padded channels
    of mixed-k entries are zeroed like the fake side, so the discriminator
    cannot win on padding alone. `r` gives the draws of
    `draw_same_speaker_rows`, else they come from `generator`."""
    if r is None:
        r = speaker_draws(generator, batch.spk_idx.shape)
    rows = draw_same_speaker_rows(batch.spk_idx, batch.utt_idx, spk_rows,
                                  spk_counts, r.to(bank.device))
    wavs = normalize_utterance(bank[rows])
    live = (batch.gains > 0).to(wavs.dtype)
    return stft_cfg(wavs, cfg).abs() * live[..., None, None]


class Wsj0MixSampler:
    """The unique utterances the list(s) of one split name, in one bank
    (`self.bank`, numpy; `device_bank()` on the device), and epoch-finite
    batches of index and gain arrays."""

    def __init__(self, list_dir, wav_root, cfg: Config, split: str = "train",
                 mix_ks: Sequence[int] = (2,),
                 max_entries: Optional[int] = None,
                 spk2idx: Optional[dict] = None, device=None):
        """`device` is where batches are mixed (default `cuda`; raises
        without a GPU unless device='cpu')."""
        self.cfg = cfg
        self.device = resolve_device(device)
        # per-k list pools with their own cursors: the mixed 1-3-speaker
        # recipe (predata_fromList_123.py:45-110); max_entries truncates
        # each pool like the reference's debug `[:17]` (:98)
        self.pools: dict = {}
        for k in mix_ks:
            path = os.path.join(list_dir, mix_list_name(k, split))
            if os.path.exists(path):
                entries = parse_mix_list(path)
                if max_entries:
                    entries = entries[:max_entries]
                if entries:
                    self.pools[k] = entries
        self.entries: List[Wsj0MixEntry] = [
            e for k in sorted(self.pools) for e in self.pools[k]]
        if not self.entries:
            raise FileNotFoundError(
                f"no mixture lists for split {split!r} in {list_dir}")
        self.k = max(self.pools)   # static channel width (smaller k padded)

        # the speaker vocabulary of the lists; a caller may inject the TRAIN
        # vocabulary so that a cv / tt sampler indexes the same embedding
        # rows
        listed = {s for e in self.entries for s in e.speakers}
        if spk2idx is None:
            self.spk2idx = {s: i for i, s in enumerate(sorted(listed))}
        else:
            self.spk2idx = dict(spk2idx)
            missing = listed - set(self.spk2idx)
            if missing:
                raise ValueError(
                    f"list speakers {sorted(missing)} absent from the "
                    f"provided spk2idx vocabulary")
        self.idx2spk = {i: s for s, i in self.spk2idx.items()}

        uniq = sorted({p for e in self.entries for p in e.paths})
        self.utt2row = {p: i for i, p in enumerate(uniq)}
        self.bank = _load_bank([os.path.join(wav_root, p) for p in uniq],
                               cfg.frame_rate, cfg.max_len)
        self._device_bank: Optional[torch.Tensor] = None

        # each speaker's bank rows (the dis-sp same-speaker pool,
        # predata_fromList_dis.py:37-66): (S, Umax) padded by repeating the
        # speaker's rows, and (S,) how many are live
        by_spk: dict = {i: [] for i in self.idx2spk}
        for e in self.entries:
            for s, p in zip(e.speakers, e.paths):
                si, r = self.spk2idx[s], self.utt2row[p]
                if r not in by_spk[si]:
                    by_spk[si].append(r)
        umax = max(max((len(v) for v in by_spk.values()), default=0), 1)
        self.spk_rows = np.zeros((len(by_spk), umax), np.int32)
        self.spk_counts = np.zeros((len(by_spk),), np.int32)
        for si, rows in by_spk.items():
            if rows:   # an injected speaker of no entry keeps zeros
                self.spk_rows[si] = (rows * umax)[:umax]
                self.spk_counts[si] = len(rows)

        # per-k index arrays padded to the static width self.k (a padded
        # channel: utterance row 0, speaker 0, live 0, so zero gain)
        self._per_k: dict = {}
        for k, entries in self.pools.items():
            n = len(entries)
            utt = np.zeros((n, self.k), np.int32)
            db = np.zeros((n, self.k), np.float32)
            spk = np.zeros((n, self.k), np.int32)
            live = np.zeros((n, self.k), np.float32)
            for i, e in enumerate(entries):
                utt[i, :k] = [self.utt2row[p] for p in e.paths]
                db[i, :k] = e.gains_db
                spk[i, :k] = [self.spk2idx[s] for s in e.speakers]
                live[i, :k] = 1.0
            self._per_k[k] = (utt, db, spk, live)

    @property
    def num_speakers(self) -> int:
        return len(self.spk2idx)

    def num_batches(self, batch_size: int) -> int:
        """Full batches an epoch yields: floor division per k-pool, each
        pool giving len_k // batch_size batches before the cursor moves on
        (predata_fromList.py:90; predata_fromList_123.py)."""
        return sum(len(v[0]) // batch_size for v in self._per_k.values())

    def epoch(self, batch_size: int, shuffle: bool = True, seed: int = 0
              ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]]:
        """(utt_idx, gains_db, spk_idx, live) numpy batches until every pool
        is exhausted (the reference's `yield False`,
        predata_fromList.py:100). Batches are uniform in k; the epoch takes
        the per-k blocks in a random order, each in a random entry order
        (predata_fromList_123.py:84-110), from numpy's default_rng(seed):
        the JAX sampler's arrays for the same seed."""
        rng = np.random.default_rng(seed)
        ks = sorted(self._per_k)
        if shuffle:
            rng.shuffle(ks)
        for k in ks:
            utt, db, spk, live = self._per_k[k]
            order = np.arange(len(utt))
            if shuffle:
                rng.shuffle(order)
            for b in range(len(utt) // batch_size):
                sel = order[b * batch_size:(b + 1) * batch_size]
                yield utt[sel], db[sel], spk[sel], live[sel]

    def device_bank(self) -> torch.Tensor:
        """The bank on the sampler's device, uploaded ONCE and kept: at the
        official scale it is 12,054 utterances, ~1.9 GB, and uploading it
        every epoch would dominate an epoch."""
        if self._device_bank is None:
            self._device_bank = torch.as_tensor(self.bank,
                                                device=self.device)
        return self._device_bank

    def spk_tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(spk_rows, spk_counts) on the sampler's device, as int64."""
        return (torch.as_tensor(self.spk_rows, device=self.device).long(),
                torch.as_tensor(self.spk_counts, device=self.device).long())

    def to_batch(self, utt, db, spk, live,
                 shifts: Optional[torch.Tensor] = None) -> MixtureBatch:
        """One `epoch` batch of numpy arrays mixed on the device."""
        dev = self.device

        def t(a, dtype):
            return torch.as_tensor(a, dtype=dtype).to(dev)
        return mix_from_list(self.device_bank(), t(utt, torch.long),
                             t(db, torch.float32), t(spk, torch.long),
                             self.cfg, live=t(live, torch.float32),
                             shifts=None if shifts is None else shifts.to(dev))

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                augment: bool = False) -> Iterator[MixtureBatch]:
        """The `epoch` batches, mixed on the device. augment=True rolls every
        source by a random shift (AUGMENT_DATA, predata_fromList.py:
        150-152) drawn from a generator seeded from `seed`; eval / cv
        batches keep it off, like the reference's train_or_test gate."""
        gen = (torch.Generator().manual_seed(seed + 15485863) if augment
               else None)
        for utt, db, spk, live in self.epoch(batch_size, shuffle, seed):
            shifts = (torch.randint(0, self.cfg.max_len, utt.shape,
                                    generator=gen) if augment else None)
            yield self.to_batch(utt, db, spk, live, shifts)
