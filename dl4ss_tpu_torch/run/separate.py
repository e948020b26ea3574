"""Separation CLI — separate mixture wav file(s) into given speakers.

The port of `dl4ss_tpu/run/separate.py`, top-k mode with `--speakers`:

    python -m dl4ss_tpu_torch.run.separate mix1.wav mix2.wav \
        --speakers 3,7 --out separated/ [--long] [--device cpu]

Not ported yet, each exiting with a one-line message: classifier-selected
speakers and `--mode recursive` (the LSTM kernel K7, ROADMAP P8), and
`--checkpoint-dir` / `--graft` (the port's checkpoints, ROADMAP P7).
Weights are random-initialised from `--seed` until checkpoints land.
"""

from __future__ import annotations

import argparse
import os
from typing import Sequence

import numpy as np
import torch

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.data.resample import resample_poly_kaiser
from dl4ss_tpu_torch.data.wavio import read_wav, write_wav
from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.models.separator import Separator, init_separator
from dl4ss_tpu_torch.run.common import add_common_args, build_cfg
from dl4ss_tpu_torch.serve import separate_waveforms


def _load_mix(path, cfg):
    wav, rate = read_wav(path)
    if wav.ndim > 1:
        wav = wav[:, 0]
    wav = resample_poly_kaiser(wav, rate, cfg.frame_rate)
    n = len(wav)
    if n > cfg.max_len:
        wav = wav[:cfg.max_len]
    elif n < cfg.max_len:
        wav = np.pad(wav, (0, cfg.max_len - n))
    return wav.astype(np.float32), min(n, cfg.max_len)


def _separate_chunk(model: Separator, chunk: np.ndarray, cfg: Config,
                    spk_idx: Sequence[int]) -> np.ndarray:
    device = model.encoder.proj.w.device
    mix = torch.as_tensor(chunk, device=device)[None]
    idx = torch.as_tensor(list(spk_idx), device=device)[None]
    sep = separate_waveforms(model, mix, cfg, idx, length=cfg.max_len)
    return sep[0].cpu().numpy()


def separate_long(model: Separator, wav: np.ndarray, cfg: Config,
                  spk_idx: Sequence[int], overlap_seconds: float = 1.0
                  ) -> np.ndarray:
    """Separate an arbitrarily long mixture (the reference hard-crops at
    MAX_LEN): max_len windows overlapping by `overlap_seconds`, each run
    through the separator and cross-faded. The given speakers fix the
    channel order across chunks. Returns (K, len(wav)) float32."""
    n = len(wav)
    win = cfg.max_len
    if n <= win:
        padded = np.pad(wav.astype(np.float32), (0, win - n))
        return _separate_chunk(model, padded, cfg, spk_idx)[:, :n]
    ov = min(int(overlap_seconds * cfg.frame_rate), win // 4)
    hop = win - ov
    out = np.zeros((len(spk_idx), n), np.float32)
    weight = np.zeros(n, np.float32)
    ramp = np.ones(win, np.float32)
    ramp[:ov] = np.linspace(0.0, 1.0, ov, endpoint=False)
    ramp[-ov:] = np.linspace(1.0, 0.0, ov, endpoint=False)
    for s in range(0, n - ov, hop):
        chunk = wav[s:s + win].astype(np.float32)
        if len(chunk) < win:
            chunk = np.pad(chunk, (0, win - len(chunk)))
        sep = _separate_chunk(model, chunk, cfg, spk_idx)
        valid = min(win, n - s)
        out[:, s:s + valid] += sep[:, :valid] * ramp[:valid]
        weight[s:s + valid] += ramp[:valid]
    return out / np.maximum(weight, 1e-8)


def main(argv=None):
    p = add_common_args(argparse.ArgumentParser(description=__doc__))
    p.add_argument("wavs", nargs="+", help="mixture wav files")
    p.add_argument("--mode", default="topk", choices=["topk", "recursive"])
    p.add_argument("--out", default="separated")
    p.add_argument("--speakers", default=None,
                   help="comma-separated speaker indices to extract "
                        "(required until classifier selection is ported)")
    p.add_argument("--long", action="store_true",
                   help="separate the FULL file via overlapped chunking "
                        "(the reference hard-crops at MAX_LEN)")
    p.add_argument("--graft", default=None,
                   help="checkpoint-zoo composition (not ported yet)")
    args = p.parse_args(argv)

    if args.checkpoint_dir or args.graft:
        raise SystemExit("--checkpoint-dir / --graft wait for the port's "
                         "checkpoints (ROADMAP P7)")
    if args.mode == "recursive":
        raise SystemExit("--mode recursive waits for the BiLSTM kernel K7 "
                         "(ROADMAP P8)")
    if not args.speakers:
        raise SystemExit("classifier selection waits for the BiLSTM kernel "
                         "K7 (ROADMAP P8); pass --speakers")
    cfg = build_cfg(args)
    idx = [int(x) for x in args.speakers.split(",")]
    if len(idx) != cfg.top_k:
        raise SystemExit(
            f"--speakers lists {len(idx)} speakers but the model extracts "
            f"top_k={cfg.top_k} channels; pass exactly {cfg.top_k} (or "
            f"--set top_k={len(idx)})")
    if min(idx) < 0 or max(idx) >= cfg.num_speakers:
        raise SystemExit(
            f"--speakers indices must be in [0, {cfg.num_speakers}); got "
            f"{idx}")
    device = resolve_device(args.device)
    model = init_separator(cfg, torch.Generator().manual_seed(args.seed),
                           device)
    os.makedirs(args.out, exist_ok=True)

    if args.long:
        for src_path in args.wavs:
            raw, rate = read_wav(src_path)
            if raw.ndim > 1:
                raw = raw[:, 0]
            raw = resample_poly_kaiser(raw, rate, cfg.frame_rate)
            sep = separate_long(model, raw, cfg, idx)
            stem = os.path.splitext(os.path.basename(src_path))[0]
            for k in range(sep.shape[0]):
                out_path = os.path.join(args.out, f"{stem}_ch{k}_long.wav")
                write_wav(out_path, sep[k], cfg.frame_rate)
                print("wrote", out_path, f"({sep.shape[1]} samples)")
        return

    bsz = min(cfg.batch_size, len(args.wavs))
    for start in range(0, len(args.wavs), bsz):
        paths = args.wavs[start:start + bsz]
        wavs, true_lens = zip(*[_load_mix(w, cfg) for w in paths])
        mix = torch.as_tensor(np.stack(wavs), device=device)
        spk = torch.as_tensor(idx, device=device)[None].expand(len(paths), -1)
        sep = separate_waveforms(model, mix, cfg, spk, length=cfg.max_len)
        sep = sep.cpu().numpy()
        for i, src_path in enumerate(paths):
            stem = os.path.splitext(os.path.basename(src_path))[0]
            for k in range(sep.shape[1]):
                out_path = os.path.join(
                    args.out, f"{stem}_spk{idx[k]}_step{k}.wav")
                write_wav(out_path, sep[i, k, :true_lens[i]], cfg.frame_rate)
                print("wrote", out_path)


if __name__ == "__main__":
    main()
