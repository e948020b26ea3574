"""The synthetic lip-frame bank, made on the device from a seed, as uint8
pixel values (S, C, T, H, W, 3).

The recipe of the program's `synthetic_frame_bank` (a speaker-keyed
spatial sinusoid, a phase a clip, a slow motion over the clip's frames and
a little noise, in [0, 1], as pixel values round(255 v)), drawn on the
device a speaker at a time so that the float temporaries stay a small
part of the bank; each colour channel has noise of its own. Both sides of
the comparison get this bank.
"""

from __future__ import annotations

import math

import torch


def make_frames(seed: int, speakers: int, clips: int, frames: int, hw,
                device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    h, w = hw
    yy = torch.linspace(0.0, 1.0, h, device=device)[:, None]
    xx = torch.linspace(0.0, 1.0, w, device=device)[None, :]
    motion = 0.5 * torch.sin(2 * math.pi * torch.arange(
        frames, device=device) / max(frames, 1))
    bank = torch.empty((speakers, clips, frames, h, w, 3), dtype=torch.uint8,
                       device=device)
    for s in range(speakers):
        fy, fx = 1 + s % 5, 1 + (s // 5) % 5
        phase = 2 * math.pi * torch.rand((clips, 1, 1, 1), generator=g,
                                         device=device)
        pat = torch.sin(2 * math.pi * (fy * yy + fx * xx)
                        + phase + motion[None, :, None, None])
        v = 0.5 + 0.4 * pat[..., None] + 0.05 * torch.randn(
            (clips, frames, h, w, 3), generator=g, device=device)
        bank[s] = torch.round(v.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
    return bank
