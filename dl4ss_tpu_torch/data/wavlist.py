"""Cocktail wavlists, the deterministic list-driven protocol (the port of
`dl4ss_tpu/data/wavlist.py`).

The reference's Keras evaluator re-mixes every dev/test entry from the
wavlist columns (target utterance + background utterances, normalized and
summed on the fly, Cocktail/software/DL4SS_Keras/predict.py:104-155), and
the unk protocol reads a supplemental-sounds column for enrollment audio
(predict.py:160-180, rows written by gen_file_list.py:103-128). The lists
are those `data.layout_tools.generate_file_lists` writes:

  * train rows    `wav spk`                    -> per-speaker bank
  * dev/test rows `tar bg[,bg...] spk`         -> deterministic mixtures
  * unk rows      `tar bg unk supp[,supp...]`  -> mixtures + enrollment

The unique utterances are decoded once (the native loader); each batch is
then a gather + sum on the bank's device through `mix_from_list`, rows
normalized before padding and unit gains (mean-sub -> peak-norm -> pad ->
sum, predict.py:118-140).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.data.dirtree import _load_bank
from dl4ss_tpu_torch.data.synth import MixtureBatch


class WavListRow(NamedTuple):
    target: str
    bgs: Tuple[str, ...]       # background utterances (empty for train rows)
    speaker: str               # target speaker name ('unk' on unk rows)
    supps: Tuple[str, ...]     # unk supplemental-enrollment utterances


def parse_wavlist(path: str) -> List[WavListRow]:
    """Parses the three row formats (gen_file_list.py:41-128): train rows
    have 2 columns, dev/test 3 (bg column comma-joined), unk 4 (speaker
    column 'unk')."""
    rows = []
    with open(path) as fh:
        for ln in fh:
            cols = ln.split()
            if not cols:
                continue
            if len(cols) == 2:
                rows.append(WavListRow(cols[0], (), cols[1], ()))
            elif len(cols) == 3:
                rows.append(WavListRow(cols[0], tuple(cols[1].split(",")),
                                       cols[2], ()))
            elif len(cols) == 4:
                rows.append(WavListRow(cols[0], tuple(cols[1].split(",")),
                                       cols[2], tuple(cols[3].split(","))))
            else:
                raise ValueError(f"{path}: unparseable row {ln!r}")
    if not rows:
        raise ValueError(f"{path}: empty wavlist")
    return rows


def _speaker_of(path: str) -> str:
    """Speaker name of a wavlist path: its parent directory."""
    return os.path.basename(os.path.dirname(path))


class WavListMixer:
    """Decodes the unique utterances of a dev/test/unk wavlist into one bank
    on `device` and yields its mixtures as deterministic, list-ordered
    batches."""

    def __init__(self, rows: List[WavListRow], wav_root: str, cfg: Config,
                 spk2idx: Dict[str, int], max_mix: Optional[int] = None,
                 device=None):
        self.cfg = cfg
        self.rows = rows
        # the reference mixes ([tar] + bgs)[:spk_num] (predict.py:107)
        self.k = max_mix if max_mix is not None else cfg.max_mix
        uniq = sorted({p for r in rows
                       for p in (r.target,) + r.bgs[:self.k - 1]})
        self.utt2row = {p: i for i, p in enumerate(uniq)}
        self.bank = torch.as_tensor(_load_bank(
            [os.path.join(wav_root, p) for p in uniq], cfg.frame_rate,
            cfg.max_len), device=device)
        self.spk2idx = spk2idx

    def _index_row(self, r: WavListRow):
        paths = [r.target] + list(r.bgs[:self.k - 1])
        utt = [self.utt2row[p] for p in paths]
        # channel 0's speaker comes from the row's speaker column; the
        # interferers are named by their path's parent directory
        spks = [r.speaker] + [_speaker_of(p) for p in r.bgs[:self.k - 1]]
        spk = [self.spk2idx.get(s, 0) for s in spks]
        live = [1.0] * len(paths)
        while len(utt) < self.k:                     # short rows pad dead
            utt.append(0)
            spk.append(0)
            live.append(0.0)
        return utt, spk, live

    def batches(self, batch_size: int,
                target_rows: Optional[Dict[str, int]] = None
                ) -> Iterator[Tuple[MixtureBatch, int]]:
        """Yields (MixtureBatch, n_valid) in list order; the final partial
        batch is padded by repeating its last row (score only the first
        n_valid). `target_rows` overrides channel 0's speaker ids (the unk
        protocol's enrolled memory rows)."""
        from dl4ss_tpu_torch.data.listsampler import mix_from_list
        dev = self.bank.device
        n = len(self.rows)
        for start in range(0, n, batch_size):
            chunk = self.rows[start:start + batch_size]
            n_valid = len(chunk)
            while len(chunk) < batch_size:
                chunk = chunk + [chunk[-1]]
            utt = np.zeros((batch_size, self.k), np.int64)
            spk = np.zeros((batch_size, self.k), np.int64)
            live = np.zeros((batch_size, self.k), np.float32)
            for i, r in enumerate(chunk):
                u, s, lv = self._index_row(r)
                utt[i], spk[i], live[i] = u, s, lv
                if target_rows is not None:
                    spk[i, 0] = target_rows[r.target]
            # unit gains: the reference sums the normalized signals as they
            # are (predict.py:134-140)
            batch = mix_from_list(
                self.bank, torch.as_tensor(utt, device=dev),
                torch.zeros((batch_size, self.k), device=dev),
                torch.as_tensor(spk, device=dev), self.cfg,
                live=torch.as_tensor(live, device=dev))
            yield batch, n_valid


def train_bank_from_wavlist(path: str, wav_root: str, cfg: Config,
                            utts_per_speaker: Optional[int] = None):
    """(S, U, N) numpy bank + {speaker: idx} from a `wav spk` train wavlist
    (the rows the reference's training generator mixes from,
    prepare_data.py:104-155). U = the smallest per-speaker utterance count
    (or `utts_per_speaker`), so the bank is rectangular."""
    rows = parse_wavlist(path)
    by_spk: Dict[str, List[str]] = {}
    for r in rows:
        if r.bgs:
            raise ValueError(f"{path} is not a train wavlist (bg column)")
        by_spk.setdefault(r.speaker, []).append(r.target)
    speakers = sorted(by_spk)
    u = min(len(v) for v in by_spk.values())
    if utts_per_speaker is not None:
        u = min(u, utts_per_speaker)
    paths = [os.path.join(wav_root, p) for s in speakers
             for p in sorted(by_spk[s])[:u]]
    bank = _load_bank(paths, cfg.frame_rate, cfg.max_len).reshape(
        len(speakers), u, cfg.max_len)
    return bank, {s: i for i, s in enumerate(speakers)}


def enrollment_wav(row: WavListRow, wav_root: str, cfg: Config,
                   seconds: float, supp_cap: Optional[int] = None
                   ) -> np.ndarray:
    """The unk enrollment signal: the row's supplemental utterances (up to
    `supp_cap`), each normalized, concatenated at their raw lengths, and
    the first `seconds` of them kept (predict.py:160-180). Returns
    (cfg.max_len,) float32, zero-padded."""
    from dl4ss_tpu_torch.data.resample import resample_poly_kaiser
    from dl4ss_tpu_torch.data.wavio import read_wav
    supps = row.supps[:supp_cap] if supp_cap else row.supps
    if not supps:
        raise ValueError("unk row carries no supplemental utterances")
    want = min(int(seconds * cfg.frame_rate), cfg.max_len)
    parts = []
    got = 0
    for p in supps:
        w, sr = read_wav(os.path.join(wav_root, p))
        if w.ndim > 1:
            w = w[:, 0]
        w = resample_poly_kaiser(w, sr, cfg.frame_rate)
        w = w - w.mean()
        w = w / max(float(np.abs(w).max()), 1e-8)
        parts.append(w)
        got += len(w)
        if got >= want:
            break
    wav = np.concatenate(parts)[:want]
    return np.pad(wav, (0, cfg.max_len - len(wav))).astype(np.float32)
