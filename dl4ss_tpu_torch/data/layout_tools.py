"""Dataset layout + file-list tools.

  * `layout_wsj0` rebuilds Torch_multi/Dataset_Multi/1/WSJ0_process.py:8-38:
    copy a flat `spk_all_wav/*.wav` dump into `data/{train,eval,test}/<spk>/`
    trees keyed by explicit per-split speaker lists (speaker id = the first
    3 chars of the filename, the WSJ0 convention).
  * `generate_file_lists` rebuilds Cocktail/.../gen_file_list.py: walk
    `{train,dev,test,unk}` speaker trees and emit the reference's list-file
    columns — train rows are `wav_path spk`, dev/test rows are
    `target bg[,bg...] spk` with `n_bg_test` extra sampled backgrounds for
    the test list (gen_file_list.py:95-128).

(The port's copy of `dl4ss_tpu/data/layout_tools.py`: host tools that write
files, byte-equal to the JAX package's for one seed.)
"""

from __future__ import annotations

import os
import random
import shutil
from typing import Dict, Sequence


def layout_wsj0(flat_dir, out_root, split_speakers: Dict[str, Sequence[str]],
                move: bool = False) -> Dict[str, int]:
    """split_speakers: {"train": [...spk ids...], "eval": [...], "test": [...]}"""
    counts = {s: 0 for s in split_speakers}
    op = shutil.move if move else shutil.copy2
    for fname in sorted(os.listdir(flat_dir)):
        if not fname.lower().endswith(".wav"):
            continue
        spk = fname[:3]
        for split, spks in split_speakers.items():
            if spk in spks:
                dst = os.path.join(out_root, "data", split, spk)
                os.makedirs(dst, exist_ok=True)
                op(os.path.join(flat_dir, fname), os.path.join(dst, fname))
                counts[split] += 1
                break
    return counts


def generate_file_lists(root, out_dir, n_bg_dev: int = 1, n_bg_test: int = 8,
                        seed: int = 1) -> Dict[str, str]:
    """root contains {train,dev,test[,unk]}/<spk>/*.wav trees. Returns
    {split: list path}. Speaker column = directory name."""
    rng = random.Random(seed)
    os.makedirs(out_dir, exist_ok=True)
    out = {}

    def tree(split):
        base = os.path.join(root, split)
        if not os.path.isdir(base):
            return {}
        return {spk: sorted(
            os.path.join(base, spk, w) for w in os.listdir(
                os.path.join(base, spk)) if w.lower().endswith(".wav"))
            for spk in sorted(os.listdir(base))
            if os.path.isdir(os.path.join(base, spk))}

    train = tree("train")
    path = os.path.join(out_dir, "train_wavlist.txt")
    with open(path, "w") as f:
        for spk, wavs in train.items():
            for w in wavs:
                f.write(f"{w} {spk}\n")
    out["train"] = path

    for split, n_bg in [("dev", n_bg_dev), ("test", n_bg_test)]:
        t = tree(split)
        if not t:
            continue
        all_wavs = [(w, s) for s, ws in t.items() for w in ws]
        path = os.path.join(out_dir, f"{split}_wavlist.txt")
        with open(path, "w") as f:
            for spk, wavs in t.items():
                others = [w for (w, s) in all_wavs if s != spk]
                for w in wavs:
                    bgs = rng.sample(others, min(n_bg, len(others)))
                    f.write(f"{w} {','.join(bgs)} {spk}\n")
        out[split] = path

    unk = tree("unk")
    if len(unk) == 1:
        raise ValueError(
            "unk tree has a single speaker: the unk protocol mixes each "
            "target with a background utterance of ANOTHER unk speaker "
            "(gen_file_list.py:121-128), so >=2 unk speakers are required")
    if unk:
        path = os.path.join(out_dir, "unk_wavlist.txt")
        all_unk = [(w, s) for s, ws in unk.items() for w in ws]
        with open(path, "w") as f:
            for spk, wavs in unk.items():
                # bg interferers come from OTHER unk speakers and the
                # speaker column is the literal 'unk' (the reference's
                # 4-column unk rows: `tar bg unk supp1,supp2,...`,
                # gen_file_list.py:103-128); the supplemental column holds
                # the speaker's enrollment pool (its other utterances —
                # the unk/sounds/<spk> tree collapsed onto the same tree)
                others = [w for (w, s) in all_unk if s != spk]
                for w in wavs:
                    if not others:
                        continue
                    bg = rng.choice(others)
                    supp = ",".join([x for x in wavs if x != w] or wavs)
                    f.write(f"{w} {bg} unk {supp}\n")
        out["unk"] = path
    return out
