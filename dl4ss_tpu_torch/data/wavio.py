"""Minimal WAV I/O in numpy (PCM16/24/32 + float32).

The reference reads with `soundfile` and writes separated outputs with
`sf.write` (Torch_multi/predata_multiAims.py:138, main_run.py:52-58);
soundfile is not in this image, and a dependency-free reader keeps the host
loader self-contained. Little-endian RIFF only — which is all WSJ0/GRID-style
corpora use. (The port's copy of `dl4ss_tpu/data/wavio.py`.)
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


def read_wav(path) -> Tuple[np.ndarray, int]:
    """Returns (float32 samples in [-1, 1] shaped (N,) or (N, C), rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos, fmt, fmt_body, raw = 12, None, b"", None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            fmt_body = body
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_fmt, channels, rate, _, _, bits = fmt
    if audio_fmt == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE
        # the real format code is the first u16 of the SubFormat GUID in
        # the fmt extension (base 16 + cbSize 2 + validbits 2 + mask 4)
        if len(fmt_body) < 26:
            raise ValueError(f"{path}: truncated extensible fmt chunk")
        audio_fmt = struct.unpack("<H", fmt_body[24:26])[0]
    if audio_fmt == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(raw, "u1").astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, "u1").reshape(-1, 3)
            x = ((b[:, 0].astype(np.int32)) | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 2].astype(np.int32) << 16))
            x = (x << 8 >> 8).astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"{path}: unsupported PCM bits={bits}")
    elif audio_fmt == 3:  # IEEE float
        x = np.frombuffer(raw, "<f4").astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported format code {audio_fmt}")
    if channels > 1:
        x = x.reshape(-1, channels)
    return x, rate


def wav_duration(path) -> Tuple[int, int]:
    """(num_frames, rate) from the header only — no sample decode.

    Supports the reference's `update_max_len` behavior (Torch_multi/
    config.py:29-52): cap MAX_LEN at the corpus's true longest utterance.
    """
    with open(path, "rb") as f:
        head = f.read(12)
        if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        rate, channels, bits, frames = 0, 1, 16, 0
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"fmt ":
                body = f.read(size + (size & 1))
                _, channels, rate = struct.unpack("<HHI", body[:8])
                bits = struct.unpack("<H", body[14:16])[0]
            elif cid == b"data":
                frames = size // max(channels * (bits // 8), 1)
                break
            else:
                f.seek(size + (size & 1), 1)
    return frames, rate


def update_max_len(wav_paths, max_len_samples: int, rate: int) -> int:
    """min(longest utterance in samples at `rate`, max_len_samples)."""
    longest = 0
    for p in wav_paths:
        frames, sr = wav_duration(p)
        longest = max(longest, int(round(frames * rate / max(sr, 1))))
    return min(longest, max_len_samples) if longest else max_len_samples


def write_wav(path, samples: np.ndarray, rate: int) -> None:
    """Write float samples (clipped to [-1, 1]) as PCM16."""
    x = np.asarray(samples)
    if x.ndim == 1:
        channels = 1
    else:
        channels = x.shape[1]
    pcm = np.clip(np.round(np.clip(x, -1.0, 1.0) * 32767.0), -32768, 32767
                  ).astype("<i2").tobytes()
    byte_rate = rate * channels * 2
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, rate,
                                 byte_rate, channels * 2, 16)
    hdr += b"data" + struct.pack("<I", len(pcm))
    with open(path, "wb") as f:
        f.write(hdr + pcm)
