"""Separation CLI — separate mixture wav file(s).

The port of `dl4ss_tpu/run/separate.py`. Two extraction modes, mirroring
the reference:
  * top-k: classifier-selected (or `--speakers` forced) simultaneous masks;
  * recursive: one classifier-chosen speaker per peel step.

    python -m dl4ss_tpu_torch.run.separate mix1.wav mix2.wav \
        --checkpoint-dir ck --out separated/ [--speakers 3,7] [--long]
    python -m dl4ss_tpu_torch.run.separate mix1.wav --mode recursive \
        --checkpoint-dir ck [--graft classifier=ck_cls]

The model is `--checkpoint-dir`'s latest step, under the config recorded
beside it, with the `--graft component=dir,...` components over it; with
neither, random weights from `--seed`. cRM models resynthesise their
complex spectra with the plain iSTFT, as in JAX.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.data.resample import resample_poly_kaiser
from dl4ss_tpu_torch.data.wavio import read_wav, write_wav
from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.models.separator import Separator
from dl4ss_tpu_torch.run.common import (add_common_args, build_cfg,
                                        checkpoint_cfg, restore_for_eval)
from dl4ss_tpu_torch.serve import (recursive_waveforms, select_and_separate,
                                   separate_waveforms)


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
                    spk_idx: Optional[Sequence[int]] = None) -> np.ndarray:
    device = model.encoder.proj.w.device
    mix = torch.as_tensor(chunk, device=device)[None]
    idx = None if spk_idx is None else \
        torch.as_tensor(list(spk_idx), device=device)[None]
    sep = separate_waveforms(model, mix, cfg, idx, length=cfg.max_len)
    return sep[0].cpu().numpy()


def separate_long(model: Separator, wav: np.ndarray, cfg: Config,
                  spk_idx: Optional[Sequence[int]] = None,
                  overlap_seconds: float = 1.0) -> np.ndarray:
    """Separate an arbitrarily long mixture (the reference hard-crops at
    MAX_LEN): max_len windows overlapping by `overlap_seconds`, each run
    through the separator and cross-faded. Given speakers fix the channel
    order across chunks; without them the classifier picks per chunk and
    the channels are aligned to the previous chunk by waveform correlation
    over the overlap. Returns (K, len(wav)) float32."""
    n = len(wav)
    win = cfg.max_len
    if n <= win:
        padded = np.pad(wav.astype(np.float32), (0, win - n))
        return _separate_chunk(model, padded, cfg, spk_idx)[:, :n]
    ov = min(int(overlap_seconds * cfg.frame_rate), win // 4)
    hop = win - ov
    k = cfg.top_k
    out = np.zeros((k, n), np.float32)
    weight = np.zeros(n, np.float32)
    ramp = np.ones(win, np.float32)
    ramp[:ov] = np.linspace(0.0, 1.0, ov, endpoint=False)
    ramp[-ov:] = np.linspace(1.0, 0.0, ov, endpoint=False)
    prev_tail = None
    for s in range(0, n - ov, hop):
        chunk = wav[s:s + win].astype(np.float32)
        if len(chunk) < win:
            chunk = np.pad(chunk, (0, win - len(chunk)))
        sep = _separate_chunk(model, chunk, cfg, spk_idx)
        # forced speakers already fix the channel order (and a weak chunk's
        # correlation could wrongly swap them)
        if prev_tail is not None and spk_idx is None:
            corr = np.abs(prev_tail @ sep[:, :ov].T)          # (K, K)
            perm = np.full(k, -1, np.int64)
            for _ in range(k):
                i, j = np.unravel_index(np.argmax(corr), corr.shape)
                perm[i] = j
                corr[i, :] = -1
                corr[:, j] = -1
            sep = sep[perm]
        valid = min(win, n - s)
        out[:, s:s + valid] += sep[:, :valid] * ramp[:valid]
        weight[s:s + valid] += ramp[:valid]
        prev_tail = sep[:, win - ov:win] if s + win < n else None
    return out / np.maximum(weight, 1e-8)


def main(argv=None):
    p = add_common_args(argparse.ArgumentParser(description=__doc__))
    p.add_argument("wavs", nargs="+", help="mixture wav files")
    p.add_argument("--mode", default="topk", choices=["topk", "recursive"])
    p.add_argument("--out", default="separated")
    p.add_argument("--speakers", default=None,
                   help="comma-separated speaker indices to force (teacher "
                        "mode); default: classifier selection")
    p.add_argument("--long", action="store_true",
                   help="separate the FULL file via overlapped chunking "
                        "with cross-chunk channel alignment (the reference "
                        "hard-crops at MAX_LEN)")
    p.add_argument("--graft", default=None,
                   help="checkpoint-zoo composition: comma-separated "
                        "component=ckpt_dir pairs grafted over "
                        "--checkpoint-dir (e.g. classifier=ck_cls)")
    args = p.parse_args(argv)

    cfg = checkpoint_cfg(build_cfg(args), args)
    idx = None
    if args.speakers:
        if args.mode == "recursive":
            raise SystemExit(
                "--speakers is the teacher-forced top-k mode; recursive "
                "mode selects speakers itself (one per peel step)")
        idx = [int(x) for x in args.speakers.split(",")]
        if len(idx) != cfg.top_k:
            raise SystemExit(
                f"--speakers lists {len(idx)} speakers but the model "
                f"extracts top_k={cfg.top_k} channels; pass exactly "
                f"{cfg.top_k} (or --set top_k={len(idx)})")
        if min(idx) < 0 or max(idx) >= cfg.num_speakers:
            raise SystemExit(
                f"--speakers indices must be in [0, {cfg.num_speakers}); "
                f"got {idx}")
    device = resolve_device(args.device)
    model = restore_for_eval(cfg, args, device).model
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
        if args.mode == "recursive":
            sep, chosen = recursive_waveforms(model, mix, cfg,
                                              length=cfg.max_len)
        elif idx is None:
            sep, chosen = select_and_separate(model, mix, cfg,
                                              length=cfg.max_len)
        else:
            chosen = torch.as_tensor(idx, device=device)[None].expand(
                len(paths), -1)
            sep = separate_waveforms(model, mix, cfg, chosen,
                                     length=cfg.max_len)
        sep, chosen = sep.cpu().numpy(), chosen.cpu().numpy()
        for i, src_path in enumerate(paths):
            stem = os.path.splitext(os.path.basename(src_path))[0]
            for k in range(sep.shape[1]):
                out_path = os.path.join(
                    args.out, f"{stem}_spk{int(chosen[i, k])}_step{k}.wav")
                write_wav(out_path, sep[i, k, :true_lens[i]], cfg.frame_rate)
                print("wrote", out_path)


if __name__ == "__main__":
    main()
