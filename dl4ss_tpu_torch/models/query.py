"""Query encoders, the pluggable conditioning modalities (the port of
`dl4ss_tpu/models/query.py`):

  * speech voiceprint: BiLSTM(E/2) stack over clean-speech features +
    masked mean-pool (Cocktail/.../nnet.py:66-71, MeanPool
    extend_layers.py:105-129);
  * image: 3 x [Conv+ReLU+MaxPool] -> Dense(E) over MNIST digits
    (Multi_modal/.../nnet.py:70-90);
  * video: per-frame CNN trunk (a small strided conv stack, or the frozen
    Inception-v3) -> BiLSTM -> last hidden -> Dense(E) -> speaker logits
    (VIDEO_QUERY, Torch_multi/main_run.py:226-256).

The query BiLSTMs run no kernel in JAX (`bidirectional_rnn` without
`use_pallas`, a compiled `lax.scan` there). On a CUDA tensor of a config
that asks for the recurrent kernels (cfg.use_pallas_rnn, passed as
`kernels`) the port runs them through K7 / K8 (`query_rnn`): the plain loop
is about a dozen small launches a step, and the speech query's 313 steps
made it the largest part of a memory step on the card (PERF.md). On the
CPU, and without the flag, they run the plain loop.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.models.common import (conv2d, conv_init, linear,
                                           linear_init)
from dl4ss_tpu_torch.ops.rnn import bidirectional_rnn, rnn_init
from dl4ss_tpu_torch.utils.profiling import span


def masked_mean_pool(x: torch.Tensor, mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """(B, T, D) [+ (B, T) validity mask] -> (B, D) mean over valid steps."""
    if mask is None:
        return x.mean(dim=1)
    m = mask.to(x.dtype)[..., None]
    return (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)


def query_rnn(layers: nn.ModuleList, x: torch.Tensor,
              kernels: bool = False) -> torch.Tensor:
    """A query BiLSTM stack: K7 / K8 on a CUDA tensor when `kernels`, the
    plain loop otherwise (the same function; see the module docstring)."""
    return bidirectional_rnn(layers, x, "lstm",
                             use_pallas=kernels and x.is_cuda)


# ---- speech voiceprint ----------------------------------------------------


class SpeechQuery(nn.Module):
    def __init__(self, cfg: Config, generator=None, device=None):
        super().__init__()
        half = max(cfg.embedding_size // 2, 1)
        self.rnn = rnn_init("lstm", cfg.freq_bins, half, cfg.num_layers,
                            generator, device=resolve_device(device))


def init_speech_query(cfg: Config, generator=None, device=None
                      ) -> SpeechQuery:
    return SpeechQuery(cfg, generator, device)


def apply_speech_query(params: SpeechQuery, clean_feat: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       kernels: bool = False) -> torch.Tensor:
    """clean features (B, T, F) -> voiceprint (B, 2 * (E // 2))."""
    with span("voiceprint"):
        return masked_mean_pool(query_rnn(params.rnn, clean_feat, kernels),
                                mask)


# ---- image query ----------------------------------------------------------


class ImageQuery(nn.Module):
    def __init__(self, cfg: Config, image_hw: Tuple[int, int] = (28, 28),
                 channels: int = 1, generator=None, device=None):
        super().__init__()
        device = resolve_device(device)
        h, w = image_hw
        for _ in range(3):
            h, w = h // 2, w // 2          # three 2x2 max-pools (SAME conv)
        self.conv0 = conv_init(channels, 32, 3, 3, generator, device=device)
        self.conv1 = conv_init(32, 32, 3, 3, generator, device=device)
        self.conv2 = conv_init(32, 32, 3, 3, generator, device=device)
        self.out = linear_init(h * w * 32, cfg.embedding_size,
                               generator=generator, device=device)


def init_image_query(cfg: Config, image_hw: Tuple[int, int] = (28, 28),
                     channels: int = 1, generator=None, device=None
                     ) -> ImageQuery:
    return ImageQuery(cfg, image_hw, channels, generator, device)


def apply_image_query(params: ImageQuery, images: torch.Tensor
                      ) -> torch.Tensor:
    """(B, H, W, C) -> (B, E)."""
    x = images
    for conv in (params.conv0, params.conv1, params.conv2):
        x = F.relu(conv2d(conv, x, stride=(1, 1), padding="SAME"))
        # VALID 2x2 max-pool, NHWC in and out
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    return linear(params.out, x.reshape(x.shape[0], -1))


# ---- video query ----------------------------------------------------------


class VideoQuery(nn.Module):
    """trunk='inception' is the reference's frozen Inception-v3 (its
    penultimate 2048-d feature per frame, main_run.py:226-243);
    trunk='conv' a lightweight strided-conv stand-in."""

    def __init__(self, cfg: Config, num_speakers: Optional[int] = None,
                 frame_hw: Tuple[int, int] = (299, 299),
                 trunk: str = "conv", trunk_dim: int = 256,
                 generator=None, device=None):
        super().__init__()
        device = resolve_device(device)
        s = num_speakers if num_speakers is not None else cfg.num_speakers
        if trunk == "inception":
            from dl4ss_tpu_torch.models.inception import init_inception_v3
            self.inception = init_inception_v3(generator=generator,
                                               device=device)
            feat_dim = 2048                  # size_hidden_image (:237)
        else:
            self.conv0 = conv_init(3, 32, 5, 5, generator, device=device)
            self.conv1 = conv_init(32, 64, 3, 3, generator, device=device)
            self.conv2 = conv_init(64, trunk_dim, 3, 3, generator,
                                   device=device)
            feat_dim = trunk_dim
        self.rnn = rnn_init("lstm", feat_dim, cfg.hidden_units,
                            cfg.num_layers, generator, device=device)
        self.dense = linear_init(2 * cfg.hidden_units, cfg.embedding_size,
                                 generator=generator, device=device)
        self.logits = linear_init(cfg.embedding_size, s,
                                  generator=generator, device=device)


def init_video_query(cfg: Config, num_speakers: Optional[int] = None,
                     frame_hw: Tuple[int, int] = (299, 299),
                     trunk: str = "conv", trunk_dim: int = 256,
                     generator=None, device=None) -> VideoQuery:
    return VideoQuery(cfg, num_speakers, frame_hw, trunk, trunk_dim,
                      generator, device)


def normalize_frames(frames: torch.Tensor) -> torch.Tensor:
    """uint8 pixel values -> float32 in [-1, 1] as `load_frame_dir`
    (data/video.py) normalizes them: x / 127.5 - 1, the same two roundings,
    so the result is bit-equal to the float bank's. Float frames pass
    through unchanged. A bank held as uint8 takes a quarter of the float
    bank's memory and is normalized where the trunk reads the frames."""
    if frames.dtype == torch.uint8:
        return frames.float() / 127.5 - 1.0
    return frames


def video_features(params: VideoQuery, frames: torch.Tensor) -> torch.Tensor:
    """frames (N, H, W, 3), float or uint8 (`normalize_frames`) -> per-frame
    features (N, D) of the trunk. The Inception trunk is FROZEN, as the
    reference keeps its pretrained Inception-v3 fixed (main_run.py:232-243)
    and JAX stop-gradients its parameters: it runs without autograd, so its
    parameters get zero gradients (and zero Adam updates)."""
    with span("video_trunk"):
        frames = normalize_frames(frames)
        if hasattr(params, "inception"):
            from dl4ss_tpu_torch.models.inception import apply_inception_v3
            with torch.no_grad():
                return apply_inception_v3(params.inception, frames)[2]
        # SAME padding keeps small lip crops (16x16 up) from collapsing to
        # zero spatial size before the global pool
        x = F.relu(conv2d(params.conv0, frames, stride=(4, 4),
                          padding="SAME"))
        x = F.relu(conv2d(params.conv1, x, stride=(3, 3), padding="SAME"))
        x = F.relu(conv2d(params.conv2, x, stride=(2, 2), padding="SAME"))
        return x.mean(dim=(1, 2))                     # global average pool


def apply_video_query(params: VideoQuery, frames: torch.Tensor,
                      kernels: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """frames (B, T, H, W, 3), float or uint8 -> (speaker logits (B, S),
    query (B, E)): frame features -> BiLSTM -> last timestep -> Dense(E) ->
    (logits, hidden query) (VIDEO_QUERY.forward, main_run.py:246-256)."""
    with span("query"):
        b, t = frames.shape[:2]
        x = video_features(params,
                           frames.reshape((b * t,) + frames.shape[2:]))
        h = query_rnn(params.rnn, x.reshape(b, t, -1), kernels)
        query = linear(params.dense, h[:, -1])
        return linear(params.logits, query), query
