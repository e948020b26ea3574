"""Shared CLI plumbing: preset selection + overrides + data source (the
synthetic bank or a speaker tree, `--data-root`), the noise bank, the
checkpoint-zoo graft and the video modes' frame bank (the port of
`dl4ss_tpu/run/common.py`), plus the `--device` flag."""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from dl4ss_tpu_torch.config import Config, preset, preset_names
from dl4ss_tpu_torch.data.synth import make_synthetic_bank


def add_common_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--preset", default="torch_multi", choices=preset_names(),
                   help="named configuration replicating a reference config")
    p.add_argument("--data-root", default=None,
                   help="speaker-tree root (predata_multiAims layout); "
                        "synthetic bank if omitted")
    p.add_argument("--split", default="train",
                   help="split subdirectory of --data-root, or the list "
                        "split of --list-dir (train / valid / test)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=1,
                   help="reference convention: seed 1 (main_run.py:21-23)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="directory of the run's checkpoints and cfg.json")
    p.add_argument("--metrics", default=None, help="jsonl metrics path")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any Config field, e.g. --set max_mix=3")
    p.add_argument("--utts", type=int, default=None,
                   help="utterances per speaker in the bank (default 8)")
    p.add_argument("--utts-from", type=int, default=0,
                   help="start each speaker's utterance slice at this "
                        "index (held-out banks: rehearsal corpora keep the "
                        "LAST utterances for cv / tt)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: cuda (default; fails "
                        "without a GPU) or cpu")
    return p


def apply_overrides(cfg: Config, args) -> Config:
    """Apply the CLI's --batch-size/--set overrides onto `cfg`."""
    if args.batch_size:
        cfg = cfg.replace(batch_size=args.batch_size)
    for kv in args.set:
        key, _, value = kv.partition("=")
        current = getattr(cfg, key)  # raises on unknown key
        if isinstance(current, bool):
            parsed = value.lower() in ("1", "true", "yes")
        elif isinstance(current, int):
            parsed = int(value)
        elif isinstance(current, float):
            parsed = float(value)
        else:
            parsed = value
        cfg = cfg.replace(**{key: parsed})
    return cfg


def build_cfg(args) -> Config:
    return apply_overrides(preset(args.preset), args).validate()


def load_bank(cfg: Config, args, device: torch.device,
              utts_per_speaker: int = 8):
    """(the (S, U, N) bank on `device`, `cfg` with the bank's speaker
    count, {row: speaker name}): the speaker tree under --data-root
    (--split, --utts utterances a speaker from --utts-from) or the
    synthetic bank from --seed, with --utts utterances a speaker where the
    arguments give it, else `utts_per_speaker`."""
    utts = getattr(args, "utts", None) or utts_per_speaker
    if args.data_root:
        from dl4ss_tpu_torch.data.dirtree import DirTreeSampler
        sampler = DirTreeSampler(args.data_root, cfg, args.split, utts,
                                 utts_offset=getattr(args, "utts_from", 0))
        cfg = cfg.replace(num_speakers=sampler.num_speakers)
        return (torch.as_tensor(sampler.bank, device=device), cfg,
                sampler.idx2spk)
    bank = make_synthetic_bank(args.seed, cfg.num_speakers, utts,
                               cfg.max_len)
    return (torch.as_tensor(bank, device=device), cfg,
            {i: f"spk{i:03d}" for i in range(cfg.num_speakers)})


def load_noise_bank(noise_dir: str, cfg: Config,
                    device: torch.device) -> torch.Tensor:
    """The background-noise wavs of `noise_dir` as (W, N) on `device`,
    loaded RAW: the reference adds 0.3x the decoded noise wav, not a
    peak-normalized one (predata_multiAims_noisedB.py:198)."""
    from dl4ss_tpu_torch.data.dirtree import _load_bank
    paths = sorted(os.path.join(noise_dir, f) for f in os.listdir(noise_dir)
                   if f.lower().endswith(".wav"))
    if not paths:
        raise SystemExit(f"no .wav files under {noise_dir}")
    return torch.as_tensor(_load_bank(paths, cfg.frame_rate, cfg.max_len,
                                      normalize=False), device=device)


def read_vocab(checkpoint_dir: Optional[str]) -> Optional[dict]:
    """The training vocabulary ({speaker: row}) that run.train --list-dir
    records beside its checkpoints, or None."""
    if not checkpoint_dir:
        return None
    path = os.path.join(checkpoint_dir, "vocab.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def write_vocab(checkpoint_dir: str, spk2idx: dict) -> None:
    """Record the training vocabulary beside the checkpoints, as the JAX
    CLI writes it (json.dump, byte for byte)."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    with open(os.path.join(checkpoint_dir, "vocab.json"), "w") as f:
        json.dump(spk2idx, f)


def restore_for_eval(cfg: Config, args, device: torch.device):
    """The train state the evaluating CLIs run: `cfg`'s model from --seed,
    restored from --checkpoint-dir's latest step when one is given, with
    the --graft components over it."""
    from dl4ss_tpu_torch.train.checkpoint import (latest_step,
                                                  restore_checkpoint)
    from dl4ss_tpu_torch.train.state import create_train_state
    state = create_train_state(cfg, args.seed, device=device)
    if args.checkpoint_dir:
        if latest_step(args.checkpoint_dir) is None:
            raise SystemExit(f"--checkpoint-dir {args.checkpoint_dir} holds "
                             f"no checkpoint")
        state = restore_checkpoint(args.checkpoint_dir, state)
        print(f"restored step {state.step} from {args.checkpoint_dir}")
    if getattr(args, "graft", None):
        state = apply_graft(state, args.graft, cfg)
    return state


def checkpoint_cfg(cfg: Config, args) -> Config:
    """The config an evaluating CLI runs under: --checkpoint-dir's
    cfg.json sidecar when there is one (it fixes the state shapes and the
    audio geometry), with the CLI's runtime overrides on top."""
    from dl4ss_tpu_torch.train.checkpoint import load_cfg
    if args.checkpoint_dir:
        ck_cfg = load_cfg(args.checkpoint_dir)
        if ck_cfg is not None:
            return apply_overrides(ck_cfg, args).validate()
    return cfg


def apply_graft(state, graft_arg: str, cfg: Optional[Config] = None):
    """Parse a --graft value ('component=ckpt_dir[,...]', the reference's
    hand-assembled checkpoint zoo, TestVer:557-579) and load the named
    components over `state`. Exits with one line on a malformed value or a
    component that does not fit."""
    from dl4ss_tpu_torch.train.checkpoint import load_components
    pairs = [kv.split("=", 1) for kv in graft_arg.split(",")]
    if not all(len(kv) == 2 and kv[0] and kv[1] for kv in pairs):
        raise SystemExit("--graft wants component=ckpt_dir pairs, "
                         f"got {graft_arg!r}")
    try:
        state = load_components(state, dict(pairs), cfg=cfg)
    except (KeyError, ValueError) as err:
        raise SystemExit(f"--graft: {err.args[0]}") from None
    print(f"grafted components: {', '.join(kv[0] for kv in pairs)}")
    return state


def frame_hw(args) -> tuple:
    """Frame geometry of the video trunk: Inception-v3 fixes 299x299
    (models/inception.py); the conv trunk uses --frame-size."""
    if getattr(args, "video_trunk", "conv") == "inception":
        return (299, 299)
    return (args.frame_size, args.frame_size)


def load_frame_bank(cfg: Config, args, hw, seed: int):
    """(S, C, T, H, W, 3) lip-frame bank (numpy): a GRID-style tree
    (--video-root, paired speaker-for-speaker with the audio bank,
    Torch_multi/predata.py:161-184) or the synthetic per-speaker bank; in
    float32, or as uint8 pixel values under --frame-dtype uint8, which the
    trunk normalizes on the card."""
    dtype = np.dtype(getattr(args, "frame_dtype", "float32"))
    if args.video_root:
        from dl4ss_tpu_torch.data.video import speaker_frame_bank
        frames, _ = speaker_frame_bank(args.video_root, args.frames, size=hw,
                                       dtype=dtype)
        if frames.shape[0] != cfg.num_speakers:
            raise SystemExit(
                f"--video-root has {frames.shape[0]} speakers but the audio "
                f"bank has {cfg.num_speakers}; the trees must pair "
                f"speaker-for-speaker (predata.py:161-184)")
        return frames
    from dl4ss_tpu_torch.data.video import synthetic_frame_bank
    return synthetic_frame_bank(cfg.num_speakers, 2, args.frames, hw,
                                seed=seed, dtype=dtype)
