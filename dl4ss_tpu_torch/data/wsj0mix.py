"""Official wsj0-2mix / wsj0-3mix mixture-list parsing.

Reproduces the reference's list contract (TDAA_beta/predata_fromList.py:80-116):
files `create-speaker-mixtures/mix_{k}_spk_{tr,cv,tt}.txt`, each line holding
k (wav path, gain dB) pairs, e.g.

    wsj0/si_tr_s/011/011a0101.wav 0.93421 wsj0/si_tr_s/012/012c0207.wav -0.93421

The speaker id is the 3-char path component (`/([0-9][0-9].)/`) and the
utterance name is the 8-char stem (`/(.{8})\\.wav `) — the same regexes the
reference applies (predata_fromList.py:113-116). Linear gain = 10^(dB/20)
applied per utterance (:158-159). (The port's copy of
`dl4ss_tpu/data/wsj0mix.py`.)
"""

from __future__ import annotations

import re
from typing import List, NamedTuple, Sequence


class Wsj0MixEntry(NamedTuple):
    paths: tuple          # k wav paths
    speakers: tuple       # k 3-char speaker ids
    utterances: tuple     # k 8-char utterance names
    gains_db: tuple       # k float dB gains


_SPK_RE = re.compile(r"/([0-9][0-9].)/")
_UTT_RE = re.compile(r"/(.{8})\.wav(?:\s|$)")


def parse_mix_line(line: str) -> Wsj0MixEntry:
    toks = line.split()
    if len(toks) % 2 != 0 or not toks:
        raise ValueError(f"malformed mixture line: {line!r}")
    paths = tuple(toks[0::2])
    gains = tuple(float(g) for g in toks[1::2])
    speakers, utts = [], []
    for p in paths:
        m = _SPK_RE.search("/" + p)
        speakers.append(m.group(1) if m else p.split("/")[-2])
        mu = _UTT_RE.search("/" + p + " ")
        utts.append(mu.group(1) if mu else p.split("/")[-1][:-4])
    return Wsj0MixEntry(paths, tuple(speakers), tuple(utts), gains)


def parse_mix_list(path) -> List[Wsj0MixEntry]:
    entries = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                entries.append(parse_mix_line(line))
    return entries


def mix_list_name(k: int, split: str) -> str:
    """train->tr, valid->cv, test->tt (predata_fromList.py:81-87)."""
    suffix = {"train": "tr", "valid": "cv", "test": "tt"}[split]
    return f"mix_{k}_spk_{suffix}.txt"


def speakers_in_lists(entries: Sequence[Wsj0MixEntry]) -> List[str]:
    seen = []
    for e in entries:
        for s in e.speakers:
            if s not in seen:
                seen.append(s)
    return sorted(seen)
