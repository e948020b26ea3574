"""Speaker trees on disk: decode + resample -> an utterance bank (the port
of `dl4ss_tpu/data/dirtree.py`).

The predata_multiAims directory contract (Torch_multi/predata_multiAims.py:
84-120): a root with split subdirectories (`train/eval/test`, or a wsj0
`si_tr_s`), each holding one directory per speaker full of wavs. The host
decodes, resamples to cfg.frame_rate and crops / pads to cfg.max_len with
the native loader (`dl4ss_tpu_torch.native`); mixing, gains, augmentation
and every STFT happen on the model's device (`data.synth`).

  * bank mode (`DirTreeSampler`): the whole split as one (S, U, N) bank,
    uploaded to the device once;
  * streaming mode (`StreamingTreeSampler`): host numpy batches for corpora
    too large for the device, fed through `data.loader.device_prefetch`.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from dl4ss_tpu_torch import native
from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.data.resample import resample_poly_kaiser
from dl4ss_tpu_torch.data.wavio import read_wav


def scan_speaker_tree(root, split: Optional[str] = None
                      ) -> Dict[str, List[str]]:
    """-> {speaker_id: [wav paths]}, both sorted for determinism."""
    base = os.path.join(root, split) if split else root
    out: Dict[str, List[str]] = {}
    for spk in sorted(os.listdir(base)):
        spk_dir = os.path.join(base, spk)
        if not os.path.isdir(spk_dir):
            continue
        wavs = sorted(os.path.join(spk_dir, w) for w in os.listdir(spk_dir)
                      if w.lower().endswith(".wav"))
        if wavs:
            out[spk] = wavs
    return out


def _load_fixed(path, rate: int, num_samples: int,
                normalize: bool = False) -> np.ndarray:
    """The plain (numpy / scipy) version of the native loader's
    `load_utterance`: decode, first channel, resample, crop, then (with
    `normalize`) mean-subtract and peak-normalize, then zero-pad."""
    wav, sr = read_wav(path)
    if wav.ndim > 1:
        wav = wav[:, 0]
    wav = resample_poly_kaiser(wav, sr, rate)
    if len(wav) > num_samples:
        wav = wav[:num_samples]
    if normalize:
        # reference order: crop -> mean-sub -> peak-norm -> PAD
        # (predata_fromList.py:140-176); normalizing after the zero pad
        # would leave a -mean DC offset in the padded tail
        wav = wav - wav.mean()
        wav = wav / max(float(np.abs(wav).max()), 1e-8)
    if len(wav) < num_samples:
        wav = np.pad(wav, (0, num_samples - len(wav)))
    return wav.astype(np.float32)


def _load_bank(paths, rate: int, num_samples: int,
               normalize: bool = True) -> np.ndarray:
    """(len(paths), num_samples) float32 bank from the native threaded
    loader. Rows are normalized BEFORE padding by default, so the device
    samplers' normalize_utterance leaves them as they are."""
    return native.load_batch(paths, rate, num_samples, normalize=normalize)


class DirTreeSampler:
    """A split of a speaker tree as an (S, U, N) bank (`self.bank`, numpy)
    for `sample_mixtures`."""

    def __init__(self, root, cfg: Config, split: str = "train",
                 utts_per_speaker: int = 32, utts_offset: int = 0):
        """`utts_offset` starts each speaker's slice that many utterances
        into its sorted list: training and held-out banks from one tree
        (rehearsal corpora keep the LAST utterances for cv / tt)."""
        self.cfg = cfg
        tree = scan_speaker_tree(root, split)
        self.speakers = sorted(tree)
        self.spk2idx = {s: i for i, s in enumerate(self.speakers)}
        self.idx2spk = {i: s for s, i in self.spk2idx.items()}
        u = utts_per_speaker
        flat_paths = []
        for spk in self.speakers:
            paths = tree[spk]
            if utts_offset and utts_offset + u > len(paths):
                # a wrapped held-out slice would re-include rows of the
                # training prefix and inflate eval scores
                raise ValueError(
                    f"held-out slice [{utts_offset}:{utts_offset + u}] wraps "
                    f"speaker {spk!r} ({len(paths)} utterances)")
            flat_paths.extend(paths[(utts_offset + ui) % len(paths)]
                              for ui in range(u))
        self.bank = _load_bank(flat_paths, cfg.frame_rate, cfg.max_len
                               ).reshape(len(self.speakers), u, cfg.max_len)

    @property
    def num_speakers(self) -> int:
        return len(self.speakers)


class StreamingTreeSampler:
    """Host-streaming variant for corpora too large for a device bank:
    each batch decodes just the utterances it mixes (native threaded
    loader) and is yielded as numpy arrays for `device_prefetch` and
    `featurize`. Bank mode stays the fast path at WSJ0 scale."""

    def __init__(self, root, cfg: Config, split: str = "train",
                 seed: int = 1):
        self.cfg = cfg
        self.tree = scan_speaker_tree(root, split)
        self.speakers = sorted(self.tree)
        self.spk2idx = {s: i for i, s in enumerate(self.speakers)}
        self.rng = np.random.default_rng(seed)

    def batches(self, batch_size: int, num_batches: int):
        """`num_batches` dicts of mix_wav (B, N), source_wavs (B, k, N),
        spk_idx (B, k) and unit gains (B, k), k = cfg.max_mix distinct
        speakers an item, the same numpy draws as the JAX sampler's."""
        cfg = self.cfg
        k = cfg.max_mix
        for _ in range(num_batches):
            paths, spk_idx = [], np.zeros((batch_size, k), np.int32)
            for b in range(batch_size):
                spks = self.rng.choice(len(self.speakers), k, replace=False)
                spk_idx[b] = spks
                for s in spks:
                    wavs = self.tree[self.speakers[s]]
                    paths.append(wavs[self.rng.integers(len(wavs))])
            wavs = native.load_batch(paths, cfg.frame_rate, cfg.max_len,
                                     normalize=True)
            wavs = wavs.reshape(batch_size, k, cfg.max_len)
            # the rows arrive normalized before the pad (reference order);
            # normalizing again here would put a DC offset in the tail
            yield {
                "mix_wav": wavs.sum(axis=1).astype(np.float32),
                "source_wavs": wavs.astype(np.float32),
                "spk_idx": spk_idx,
                "gains": np.ones((batch_size, k), np.float32),
            }


def split_for_train_dev_test(items: List[str],
                             fractions=(0.7, 0.1, 0.2)
                             ) -> Tuple[List[str], ...]:
    """Deterministic 70/10/20 split by sorted order, the GRID convention
    (Torch_multi/predata.py:18-34)."""
    items = sorted(items)
    n = len(items)
    a = int(round(fractions[0] * n))
    b = a + int(round(fractions[1] * n))
    return items[:a], items[a:b], items[b:]
