"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks for
    the CPU. Raises when CUDA is asked for (explicitly or by default) and no
    GPU is present — never falls back to the CPU silently.

    On CUDA it also turns TF32 off for both matmuls and cuDNN: the DSP is
    held to the reference's full-f32 `Precision.HIGHEST` matmuls at 1e-4,
    which TF32's ~3 decimal digits cannot meet.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --device "
            "cpu) to run the plain PyTorch path on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
