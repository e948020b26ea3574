"""The list-driven cells' data: the rehearsal corpus, written once per
checkout, and the batches the program's list path draws, replayed.

`corpus` writes `data/rehearsal.py::generate_corpus` at the traffic's
scale (the official one: 101 speakers x 135 utterances x 5 s, a 20,000
entry `mix_2_spk_tr.txt` with +/-2.5 dB gains) under the checkout's
benchmark cache, from the traffic's fixed seed, and reuses it after.

`ListReplay` is a frozen copy of how `Wsj0MixSampler` and `run.train`'s
list loop walk the train list: its entries, vocabulary (the speakers,
sorted) and bank rows (the unique paths, sorted), each speaker's rows in
order of first appearance; epoch e shuffled by numpy's default_rng(seed +
7919 (e + 1)), its circular shifts from a CPU generator seeded seed + 7919
(e + 1) + 15485863, its same-speaker draws from one seeded seed + 104729 +
1000003 e. The reference turns what it replays into signals itself
(`reference/lists.py`).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import wave
from pathlib import Path
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from benchmark.run import CACHE

_SPK = re.compile(r"/([0-9][0-9].)/")
LIST_NAME = "mix_2_spk_tr.txt"


def corpus(params: dict, rate: int) -> Path:
    """The corpus of `params` (the traffic's `corpus`) at `rate` Hz, its
    root; written on first use into a directory named by a hash of the
    parameters, through a temporary one renamed into place."""
    from dl4ss_tpu_torch.data.rehearsal import generate_corpus
    key = hashlib.sha256(json.dumps(dict(params, rate=rate),
                                    sort_keys=True).encode()).hexdigest()
    root = CACHE / f"rehearsal-{key[:16]}"
    if (root / "lists" / LIST_NAME).is_file():
        return root
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = CACHE / f"{root.name}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    generate_corpus(str(tmp), n_spk=params["speakers"],
                    utts=params["utterances"], seconds=params["seconds"],
                    rate=rate, tr_entries=params["train_entries"],
                    cv_entries=params["valid_entries"],
                    tt_entries=params["test_entries"],
                    db_range=params["db_range"], seed=params["seed"],
                    cv_holdout=params["holdout"])
    try:
        os.replace(tmp, root)
    except OSError:     # another process wrote it first
        shutil.rmtree(tmp, ignore_errors=True)
    return root


def epoch_seed(seed: int, epoch: int) -> int:
    return seed + 7919 * (epoch + 1)


def draw_seed(seed: int, epoch: int) -> int:
    return seed + 104729 + 1_000_003 * epoch


class Replayed(NamedTuple):
    entries: List[int]          # (B,) list entries, in batch order
    shifts: torch.Tensor        # (B, K) circular shifts
    draws: torch.Tensor         # (B, K) same-speaker draws


class ListReplay:
    def __init__(self, list_path: Path, max_len: int):
        self.entries: List[Tuple[List[str], List[float]]] = []
        for line in Path(list_path).read_text().splitlines():
            toks = line.split()
            if toks:
                self.entries.append((toks[0::2],
                                     [float(g) for g in toks[1::2]]))
        self.max_len = max_len
        speakers = sorted({self.speaker(p) for paths, _ in self.entries
                           for p in paths})
        self.spk2idx = {s: i for i, s in enumerate(speakers)}
        self.paths = sorted({p for paths, _ in self.entries for p in paths})
        row = {p: i for i, p in enumerate(self.paths)}
        self.rows: Dict[int, List[int]] = {i: [] for i in
                                           range(len(speakers))}
        for paths, _ in self.entries:
            for p in paths:
                rows = self.rows[self.spk2idx[self.speaker(p)]]
                if row[p] not in rows:
                    rows.append(row[p])
        self.row = row

    @staticmethod
    def speaker(path: str) -> str:
        m = _SPK.search("/" + path)
        return m.group(1) if m else path.split("/")[-2]

    def batch(self, seed: int, epoch: int, index: int, b: int) -> Replayed:
        """Batch `index` of epoch `epoch` of a run seeded `seed`."""
        rng = np.random.default_rng(epoch_seed(seed, epoch))
        rng.shuffle([2])                    # the order of the k pools
        order = np.arange(len(self.entries))
        rng.shuffle(order)
        k = len(self.entries[0][0])
        shifts = torch.Generator().manual_seed(epoch_seed(seed, epoch)
                                               + 15485863)
        draws = torch.Generator().manual_seed(draw_seed(seed, epoch))
        for _ in range(index + 1):
            shift = torch.randint(0, self.max_len, (b, k), generator=shifts)
            draw = torch.randint(0, 1 << 30, (b, k), generator=draws)
        sel = order[index * b:(index + 1) * b]
        return Replayed([int(i) for i in sel], shift, draw)

    def same_speaker_row(self, spk: int, utt_row: int, r: int) -> int:
        """The bank row of another utterance of speaker `spk`: draw r
        modulo their count, stepping on where it is the mixed one."""
        rows = self.rows[spk]
        i = r % len(rows)
        if rows[i] == utt_row and len(rows) > 1:
            return rows[(i + 1) % len(rows)]
        return rows[i]


class Decoded:
    """The utterances of a corpus as float32 rows of `max_len` samples:
    PCM16 / 32768, cut to `max_len`, mean-subtracted and peak-normalised,
    then zero-padded; decoded on first use and kept."""

    def __init__(self, root: Path, max_len: int, device):
        self.root, self.max_len, self.device = Path(root), max_len, device
        self.cache: Dict[str, torch.Tensor] = {}

    def __call__(self, path: str) -> torch.Tensor:
        if path not in self.cache:
            with wave.open(str(self.root / path), "rb") as f:
                if f.getsampwidth() != 2 or f.getnchannels() != 1:
                    raise ValueError(f"{path}: not mono PCM16")
                pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
            wav = torch.from_numpy(pcm[:self.max_len].astype(np.float32)
                                   / 32768.0)
            wav = wav - wav.mean()
            wav = wav / wav.abs().max().clamp(min=1e-8)
            row = torch.zeros(self.max_len)
            row[:len(wav)] = wav
            self.cache[path] = row.to(self.device)
        return self.cache[path]

