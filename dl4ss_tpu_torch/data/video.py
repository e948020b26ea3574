"""GRID audio-visual data plumbing: lip-frame extraction + frame loading (a
copy of `dl4ss_tpu/data/video.py`, numpy and PIL only).

Rebuilds the reference's video path (Torch_multi/predata.py:37-51,161-184):
frames are extracted from `.mpg`/`.mp4` clips with an ffmpeg subprocess at a
fixed fps, then read back as resized RGB arrays. Machines without ffmpeg can
point `load_frame_dir` at pre-extracted frame directories instead — the
on-device side sees (B, T_frames, H, W, 3) float arrays, or uint8 pixel
values that the trunk normalizes where it reads them.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional, Tuple

import numpy as np


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def extract_frames(video_path, out_dir, fps: int = 25,
                   size: Tuple[int, int] = (299, 299)) -> List[str]:
    """ffmpeg subprocess extraction (predata.py:37-51): writes
    out_dir/%03d.png and returns the sorted frame paths."""
    os.makedirs(out_dir, exist_ok=True)
    cmd = ["ffmpeg", "-y", "-loglevel", "error", "-i", str(video_path),
           "-vf", f"fps={fps},scale={size[0]}:{size[1]}",
           os.path.join(out_dir, "%03d.png")]
    subprocess.run(cmd, check=True)
    return sorted(os.path.join(out_dir, f) for f in os.listdir(out_dir)
                  if f.endswith(".png"))


def load_frame_dir(frame_dir, total_frames: int,
                   size: Tuple[int, int] = (299, 299),
                   normalize: bool = True) -> np.ndarray:
    """Read up to total_frames images (PIL), resize, -> (T, H, W, 3) f32.

    Short clips repeat the last frame (a fixed T), matching the
    reference's fixed `total_frames` contract (predata.py:161-184)."""
    from PIL import Image
    paths = sorted(os.path.join(frame_dir, f) for f in os.listdir(frame_dir)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    if not paths:
        raise FileNotFoundError(f"no frames in {frame_dir}")
    frames = []
    for p in paths[:total_frames]:
        img = Image.open(p).convert("RGB").resize(size)
        frames.append(np.asarray(img, np.float32))
    while len(frames) < total_frames:
        frames.append(frames[-1])
    out = np.stack(frames)
    if normalize:
        out = out / 127.5 - 1.0  # inception-style [-1, 1]
    return out


def load_video_bank(clip_dirs: List[str], total_frames: int,
                    size: Tuple[int, int] = (299, 299)) -> np.ndarray:
    """-> (N_clips, T, H, W, 3) float32 bank for device upload."""
    return np.stack([load_frame_dir(d, total_frames, size)
                     for d in clip_dirs])


_VIDEO_EXTS = (".mpg", ".mpeg", ".mp4", ".avi", ".mov")


def speaker_frame_bank(root, total_frames: int,
                       size: Tuple[int, int] = (48, 48),
                       clips_per_speaker: Optional[int] = None,
                       fps: int = 25, dtype=np.float32):
    """GRID-style speaker tree -> per-speaker clip bank.

    Layout (the reference pairs each speaker's lip videos with their audio,
    Torch_multi/predata.py:161-184):

        root/<speaker>/<clip>/frame PNGs     (pre-extracted), or
        root/<speaker>/<clip>.mpg|.mp4|...   (extracted via ffmpeg into
                                              root/.frames_cache/)

    Returns (bank (S, C, T, H, W, 3), idx2spk dict). Every speaker
    contributes the same static clip count C (min across speakers, or
    `clips_per_speaker`); speakers with fewer clips cycle their existing
    ones — static shapes keep the downstream gather simple. The bank is
    float32 in [-1, 1], or with dtype=np.uint8 the frames' pixel values,
    which `models.query.normalize_frames` maps to the float bank's values
    exactly, at a quarter of its size.
    """
    speakers = sorted(d for d in os.listdir(root)
                      if os.path.isdir(os.path.join(root, d))
                      and not d.startswith("."))
    if not speakers:
        raise FileNotFoundError(f"no speaker directories under {root}")
    per_spk: List[List[str]] = []
    for spk in speakers:
        sdir = os.path.join(root, spk)
        clip_dirs = []
        for entry in sorted(os.listdir(sdir)):
            path = os.path.join(sdir, entry)
            if os.path.isdir(path):
                clip_dirs.append(path)
            elif entry.lower().endswith(_VIDEO_EXTS):
                cache = os.path.join(root, ".frames_cache", spk,
                                     os.path.splitext(entry)[0])
                if not os.path.isdir(cache) or not os.listdir(cache):
                    if not ffmpeg_available():
                        raise RuntimeError(
                            f"{path} needs ffmpeg for frame extraction; "
                            f"pre-extract frames into a directory instead")
                    extract_frames(path, cache, fps=fps, size=size)
                clip_dirs.append(cache)
        if not clip_dirs:
            raise FileNotFoundError(f"speaker {spk!r} has no clips")
        per_spk.append(clip_dirs)
    n_clips = clips_per_speaker or min(len(c) for c in per_spk)
    raw = np.dtype(dtype) == np.uint8
    bank = np.stack([
        np.stack([load_frame_dir(clips[c % len(clips)], total_frames, size,
                                 normalize=not raw).astype(dtype)
                  for c in range(n_clips)])
        for clips in per_spk])
    return bank, {i: s for i, s in enumerate(speakers)}


def synthetic_frame_bank(num_speakers: int, clips_per_speaker: int = 2,
                         total_frames: int = 4,
                         size: Tuple[int, int] = (48, 48),
                         seed: int = 0, dtype=np.float32) -> np.ndarray:
    """Deterministic speaker-identifiable 'lip video' stand-in
    (S, C, T, H, W, 3): a speaker-keyed spatial pattern with per-clip phase
    jitter and per-frame motion, so the video-query pipeline can be trained
    and tested with no GRID download — the counterpart of the MNIST glyph
    fallback (data/mnist.py synthetic_digits). float32 values lie in
    [0, 1]; dtype=np.uint8 gives them as pixel values, round(255 v), which
    the trunk reads as an image's (`models.query.normalize_frames`)."""
    rng = np.random.default_rng(seed)
    h, w = size
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    bank = np.zeros((num_speakers, clips_per_speaker, total_frames,
                     h, w, 3), np.float32)
    for s in range(num_speakers):
        fy, fx = 1 + s % 5, 1 + (s // 5) % 5       # speaker-keyed frequencies
        for c in range(clips_per_speaker):
            phase = rng.uniform(0, 2 * np.pi)
            for t in range(total_frames):
                motion = 0.5 * np.sin(2 * np.pi * t / max(total_frames, 1))
                pat = np.sin(2 * np.pi * (fy * yy + fx * xx)
                             + phase + motion)
                frame = 0.5 + 0.4 * pat + 0.05 * rng.standard_normal((h, w))
                bank[s, c, t] = np.clip(frame, 0, 1)[..., None]
    if np.dtype(dtype) == np.uint8:
        return np.round(bank * 255.0).astype(np.uint8)
    return bank
