"""Real-scale wsj0-2mix dress-rehearsal corpus generator.

The BASELINE.md acceptance condition (SI-SDR parity on the official
wsj0-2mix lists) needs the licensed WSJ0 corpus, which this environment
does not have (docs/WSJ0_RECIPE.md). This tool generates a synthetic
corpus AT THE REAL RECIPE'S SCALE so the entire list pipeline — decode,
bank residency, vocabulary, epoch accounting, eval protocol — is exercised
under production load, not toy demos:

  * 101 speakers under `wsj0/si_tr_s/<spk>/` (the official training
    inventory, TDAA_beta/predata_fromList.py:71-75), ~135 utterances each
    (~13.6k wav files, ~2.2 GB decoded bank at 5 s / 8 kHz f32);
  * `mix_2_spk_tr.txt` with 20,000 entries, `mix_2_spk_cv.txt` 5,000,
    `mix_2_spk_tt.txt` 3,000 — the official list sizes, in the official
    `path gain_dB path gain_dB` format (predata_fromList.py:113-116) with
    gains drawn +/- 2.5 dB like the MERL recipe;
  * optional `mix_1_spk_*.txt` / `mix_3_spk_*.txt` pools for the mixed-k
    recipe (predata_fromList_123.py).

NOTE the one documented deviation: the official tt lists draw from 18
UNSEEN si_et_05 speakers; a speaker-embedding model cannot teacher-force
ids outside its training vocabulary (neither could the reference's), so
tt here pairs held-out utterances of the SAME 101 speakers. Unseen-speaker
evaluation is the unk-enrollment protocol (`run.evaluate --mode memory
--unk-root`) instead.

    python -m dl4ss_tpu_torch.data.rehearsal --out /data/rehearsal
    python -m dl4ss_tpu_torch.run.train --preset torch_multi \
        --list-dir /data/rehearsal/lists --wav-root /data/rehearsal ...

(The port's copy of `dl4ss_tpu/data/rehearsal.py`: the same files, byte for
byte, for one seed.) `cocktail_layout` lays Cocktail's train / dev / test
/ unk tree over such corpora.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from dl4ss_tpu_torch.data.synth import make_synthetic_bank
from dl4ss_tpu_torch.data.wavio import write_wav
from dl4ss_tpu_torch.data.wsj0mix import mix_list_name


def _speaker_ids(n: int):
    """Official-looking ids: 011, 012, ... (three alphanumerics)."""
    return [f"{i + 11:03d}" for i in range(n)]


def generate_corpus(out_root: str, n_spk: int = 101, utts: int = 135,
                    seconds: float = 5.0, rate: int = 8000,
                    tr_entries: int = 20000, cv_entries: int = 5000,
                    tt_entries: int = 3000, db_range: float = 2.5,
                    mix_ks=(2,), seed: int = 1, cv_holdout: int = 10,
                    timbre: bool = True):
    """Writes the tree + lists. Returns a stats dict. The last `cv_holdout`
    utterances of every speaker feed cv/tt only (held-out content, seen
    speakers — the official cv protocol draws cv from si_tr_s too).

    timbre=True gives every speaker a fixed harmonic envelope on top of its
    f0 (see data.synth.make_synthetic_bank): without it, exact speaker ID from unseen
    utterances is near-unidentifiable at 101 speakers, which caps every
    classifier-driven workflow the rehearsal is meant to exercise."""
    rng = np.random.default_rng(seed)
    spks = _speaker_ids(n_spk)
    t0 = time.time()
    bank = make_synthetic_bank(seed, n_spk, utts, int(seconds * rate), rate,
                               timbre=timbre)
    gen_s = time.time() - t0

    t0 = time.time()
    rel = {}
    for si, spk in enumerate(spks):
        d = os.path.join(out_root, "wsj0", "si_tr_s", spk)
        os.makedirs(d, exist_ok=True)
        for u in range(utts):
            name = f"{spk}c{u:04d}.wav"
            write_wav(os.path.join(d, name), 0.8 * bank[si, u], rate)
            rel[(si, u)] = f"wsj0/si_tr_s/{spk}/{name}"
    write_s = time.time() - t0

    n_train_utt = utts - cv_holdout

    def draw(split_rng, n_entries, k, train_split):
        lines = []
        for _ in range(n_entries):
            chosen = split_rng.choice(n_spk, size=k, replace=False)
            parts = []
            for si in chosen:
                if train_split:
                    u = int(split_rng.integers(0, n_train_utt))
                else:
                    u = int(split_rng.integers(n_train_utt, utts))
                g = float(split_rng.uniform(-db_range, db_range))
                parts.append(f"{rel[(int(si), u)]} {g:.6f}")
            lines.append(" ".join(parts))
        return lines

    ldir = os.path.join(out_root, "lists")
    os.makedirs(ldir, exist_ok=True)
    counts = {}
    for k in mix_ks:
        for split, n_entries, train_split in (
                ("train", tr_entries, True),
                ("valid", cv_entries, False),
                ("test", tt_entries, False)):
            lines = draw(rng, n_entries, k, train_split)
            path = os.path.join(ldir, mix_list_name(k, split))
            with open(path, "w") as fh:
                fh.write("\n".join(lines) + "\n")
            counts[os.path.basename(path)] = len(lines)

    stats = {"speakers": n_spk, "utterances": n_spk * utts,
             "wav_bytes": n_spk * utts * int(seconds * rate) * 2,
             "bank_bytes_f32": n_spk * utts * int(seconds * rate) * 4,
             "generate_seconds": round(gen_s, 1),
             "write_seconds": round(write_s, 1), "lists": counts}
    return stats


def cocktail_layout(corpus_root: str, out_root: str, holdout: int,
                    unk_root: str | None = None) -> str:
    """Cocktail's `{train,dev,test[,unk]}/<spk>/*.wav` tree over corpora
    that `generate_corpus` wrote, as symbolic links, for
    `layout_tools.generate_file_lists`: each speaker's utterances but the
    last `holdout` train, the held-out ones go to dev (the first half)
    and test (the rest) under the same speaker, and `unk_root`'s speakers
    (another corpus, with other speakers) form the unk split, named
    `u<id>`. Returns `out_root`."""
    def speakers(root):
        base = os.path.join(root, "wsj0", "si_tr_s")
        return {s: sorted(os.path.join(base, s, w)
                          for w in os.listdir(os.path.join(base, s)))
                for s in sorted(os.listdir(base))}

    def link(paths, split, spk):
        d = os.path.join(out_root, split, spk)
        os.makedirs(d, exist_ok=True)
        for p in paths:
            os.symlink(os.path.abspath(p),
                       os.path.join(d, os.path.basename(p)))

    for spk, paths in speakers(corpus_root).items():
        if len(paths) <= holdout or holdout < 2:
            raise ValueError(f"speaker {spk!r} has {len(paths)} "
                             f"utterances: cannot hold out {holdout} for "
                             f"dev and test")
        link(paths[:-holdout], "train", spk)
        link(paths[-holdout:-holdout // 2], "dev", spk)
        link(paths[-holdout // 2:], "test", spk)
    if unk_root is not None:
        for spk, paths in speakers(unk_root).items():
            link(paths, "unk", "u" + spk)
    return out_root


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--speakers", type=int, default=101)
    p.add_argument("--utts", type=int, default=135)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--tr", type=int, default=20000)
    p.add_argument("--cv", type=int, default=5000)
    p.add_argument("--tt", type=int, default=3000)
    p.add_argument("--mix-k", default="2",
                   help="comma-separated k pools (e.g. 1,2,3)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--f0-only", action="store_true",
                   help="reproduce the v1 corpus (speakers identified by f0 "
                        "alone, no per-speaker timbre; speaker ID from "
                        "held-out utterances is near-unidentifiable on it)")
    args = p.parse_args(argv)
    ks = tuple(int(x) for x in args.mix_k.split(","))
    stats = generate_corpus(args.out, args.speakers, args.utts, args.seconds,
                            tr_entries=args.tr, cv_entries=args.cv,
                            tt_entries=args.tt, mix_ks=ks, seed=args.seed,
                            timbre=not args.f0_only)
    for k, v in stats.items():
        print(f"{k}: {v}")
    return stats


if __name__ == "__main__":
    main()
