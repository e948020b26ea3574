"""DPRNN-TasNet: time-domain separation with dual-path BiLSTM blocks (Luo,
Chen and Yoshioka, "Dual-path RNN", ICASSP 2020, arXiv:1910.06379,
sections 2-4). The port's one time-domain model; the JAX package has no
counterpart.

    w    = ReLU(conv1d(x; N filters of L samples, stride L/2)), (B, N, T')
    y    = gLN(w) -> 1x1 conv N -> D (with bias), (B, T', D)
    Y    = chunks of K frames at hop P of y padded with P zeros in front and
           at least P behind, (B, S, K, D) channels-last
    each of R blocks:
         Y <- Y + gLN(Linear_{2H->D}(BiLSTM over the K frames of a chunk))
         Y <- Y + gLN(Linear_{2H->D}(BiLSTM over the S chunks of a frame))
    Z    = 1x1 conv D -> C * N (with bias) of PReLU(Y), overlap-added back
           to T' frames; masks M_c = sigmoid(Z_c)
    s_c  = conv_transpose1d(M_c * w; N -> 1, L samples, stride L/2)

gLN normalises over all of (channels, time) of a sample with a
per-channel affine (GroupNorm(1, C), eps 1e-8). Each BiLSTM is an
`ops.rnn.rnn_init("lstm", D, H, 1)` stack run by `bidirectional_rnn`, so
on the card the recurrences are K7 (forward) and K8 (backward): an intra
layer runs B*S rows of K steps, an inter layer B*K rows of S steps.
Parameters are named like the benchmark's reference loads them: a 1x1
convolution or a Linear keeps `w (in, out)` and `b`, a filter bank `w
(N, L)`, a norm `gamma` and `beta`, the PReLU its one slope `a`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.models.common import Linear, linear
from dl4ss_tpu_torch.ops.rnn import bidirectional_rnn, rnn_init
from dl4ss_tpu_torch.utils.profiling import span

GLN_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class DPRNNConfig:
    """The paper's best configuration (Table 1, the L=2, K=250 row)."""
    filters: int = 64          # N, encoder filters
    kernel: int = 2            # L, encoder / decoder filter length
    bottleneck: int = 64       # D
    hidden: int = 128          # H, BiLSTM units per direction
    blocks: int = 6            # R
    chunk: int = 250           # K, frames per chunk
    hop: int = 125             # P, chunk hop
    speakers: int = 2          # C

    def __post_init__(self):
        if self.kernel % 2 or self.kernel < 2:
            raise ValueError("the filter length L must be even: the stride "
                             "is L/2")
        if self.chunk % self.hop:
            raise ValueError("the chunk K must be a whole number of hops P")

    @property
    def stride(self) -> int:
        return self.kernel // 2

    def padding(self, frames: int):
        """(front, back) zeros of the segmentation: P in front, then the
        fewest, at least P, that make (length - K) a multiple of P."""
        p, k = self.hop, self.chunk
        return p, p + (-(frames + 2 * p - k)) % p

    def num_chunks(self, frames: int) -> int:
        """S, the chunks of T' frames."""
        front, back = self.padding(frames)
        return (frames + front + back - self.chunk) // self.hop + 1


class Norm(nn.Module):
    """gLN's per-channel affine: `gamma` ones, `beta` zeros."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels, device=device))
        self.beta = nn.Parameter(torch.zeros(channels, device=device))


def gln(p: Norm, x: torch.Tensor, channel_dim: int = -1) -> torch.Tensor:
    """Global layer norm: each sample normalised over all its axes, then
    the per-channel affine along `channel_dim`."""
    dims = tuple(range(1, x.dim()))
    var, mean = torch.var_mean(x, dim=dims, unbiased=False, keepdim=True)
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    return ((x - mean) * torch.rsqrt(var + GLN_EPS) * p.gamma.view(shape)
            + p.beta.view(shape))


class Filters(nn.Module):
    """A bank of N filters of L samples, `w (N, L)`."""

    def __init__(self, n: int, length: int, scale: float, generator=None,
                 device=None):
        super().__init__()
        w = torch.empty((n, length)).uniform_(-scale, scale,
                                              generator=generator)
        self.w = nn.Parameter(w.to(device))


class PathRNN(nn.Module):
    """One half of a dual-path block: a one-layer BiLSTM, its Linear back
    to D and its gLN."""

    def __init__(self, m: DPRNNConfig, generator=None, device=None):
        super().__init__()
        self.rnn = rnn_init("lstm", m.bottleneck, m.hidden, 1, generator,
                            device=device)
        self.proj = Linear(2 * m.hidden, m.bottleneck, True, generator,
                           device=device)
        self.norm = Norm(m.bottleneck, device)


class Block(nn.Module):
    def __init__(self, m: DPRNNConfig, generator=None, device=None):
        super().__init__()
        self.intra = PathRNN(m, generator, device)
        self.inter = PathRNN(m, generator, device)


class DPRNN(nn.Module):
    """encoder, norm, bottleneck, blocks.<r>.{intra,inter}, prelu, mask,
    decoder, at torch's default initial scales."""

    def __init__(self, m: DPRNNConfig, generator=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = m
        self.encoder = Filters(m.filters, m.kernel, 1.0 / np.sqrt(m.kernel),
                               generator, device)
        self.norm = Norm(m.filters, device)
        self.bottleneck = Linear(m.filters, m.bottleneck, True, generator,
                                 device=device)
        self.blocks = nn.ModuleList(Block(m, generator, device)
                                    for _ in range(m.blocks))
        self.prelu = nn.Module()
        self.prelu.a = nn.Parameter(torch.full((1,), 0.25, device=device))
        self.mask = Linear(m.bottleneck, m.speakers * m.filters, True,
                           generator, device=device)
        self.decoder = Filters(m.filters, m.kernel, 1.0 / np.sqrt(m.kernel),
                               generator, device)

    def forward(self, mix: torch.Tensor, use_pallas: bool = False
                ) -> torch.Tensor:
        """mix (B, T) -> the speakers' waveforms (B, C, T), the spans
        `tasnet_encoder`, `intra_chunk`, `inter_chunk` and `tasnet_decoder`
        around the phases; `use_pallas` runs the BiLSTMs on K7 / K8 (the
        config's use_pallas_rnn)."""
        m = self.cfg
        b, samples = mix.shape
        with span("tasnet_encoder"):
            w = F.relu(F.conv1d(mix[:, None], self.encoder.w[:, None],
                                stride=m.stride))              # (B, N, T')
            frames = w.shape[-1]
            y = linear(self.bottleneck,
                       gln(self.norm, w, channel_dim=1).transpose(1, 2))
            chunks = segment(y, m)                             # (B, S, K, D)
        for block in self.blocks:
            with span("intra_chunk"):
                chunks = _path(block.intra, chunks, use_pallas)
            with span("inter_chunk"):
                chunks = _path(block.inter, chunks.transpose(1, 2),
                               use_pallas).transpose(1, 2)
        with span("tasnet_decoder"):
            z = linear(self.mask, F.prelu(chunks, self.prelu.a))
            masks = torch.sigmoid(overlap_add(z, frames, m))   # (B, T', CN)
            masks = masks.view(b, frames, m.speakers,
                               m.filters).permute(0, 2, 3, 1)
            est = F.conv_transpose1d(
                (masks * w[:, None]).reshape(b * m.speakers, m.filters,
                                             frames),
                self.decoder.w[:, None], stride=m.stride)
            return est.view(b, m.speakers, -1)[..., :samples]


def segment(y: torch.Tensor, m: DPRNNConfig) -> torch.Tensor:
    """y (B, T', D) -> chunks (B, S, K, D): chunk s holds the padded frames
    s*P .. s*P + K - 1."""
    b, frames, d = y.shape
    front, back = m.padding(frames)
    hops = (frames + front + back) // m.hop
    yp = F.pad(y, (0, 0, front, back)).view(b, hops, m.hop, d)
    s = m.num_chunks(frames)
    return torch.cat([yp[:, j:j + s] for j in range(m.chunk // m.hop)],
                     dim=2)


def overlap_add(z: torch.Tensor, frames: int, m: DPRNNConfig
                ) -> torch.Tensor:
    """chunks (B, S, K, F) -> (B, T', F): every chunk added back at its
    frames, the padding dropped."""
    b, s, _, f = z.shape
    front, back = m.padding(frames)
    pieces = m.chunk // m.hop
    zp = z.view(b, s, pieces, m.hop, f)
    out = z.new_zeros((b, s + pieces - 1, m.hop, f))
    for j in range(pieces):
        out = out + F.pad(zp[:, :, j], (0, 0, 0, 0, j, pieces - 1 - j))
    return out.view(b, -1, f)[:, front:front + frames]


def _path(p: PathRNN, x: torch.Tensor, use_pallas: bool) -> torch.Tensor:
    """x (B, rows, steps, D) -> x + gLN(Linear(BiLSTM over the steps))."""
    b, rows, steps, d = x.shape
    h = bidirectional_rnn(p.rnn, x.reshape(b * rows, steps, d), "lstm",
                          use_pallas)
    return x + gln(p.norm, linear(p.proj, h).view(b, rows, steps, d))
