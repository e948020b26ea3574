"""The audio-visual separator of the GRID configuration (DL4SS
Torch_multi/main_run.py, VIDEO_QUERY): its parameters from a seed, the
video query and the query training step.

Video query: the Inception-v3 trunk's 2048-d feature of every frame,
frozen (no gradient reaches it), a 2-layer BiLSTM over the frames, its
last step, a dense layer to the E-d query and a linear layer to the
speaker logits. The query of each channel takes the place of the speaker
embedding in the separator. The step's loss is the PIT MSE of the masked
magnitudes plus the cross-entropy of the queries' logits against the
channels' speakers; clipped Adam steps every parameter, the frozen
trunk's with a zero gradient.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import torch
import torch.nn.functional as F

from benchmark.reference import inception, model, rnn, train
from benchmark.reference.params import _linear, _rnn, param_spec

TRUNK = "video_query.inception."
BLOCK = 256          # frames a trunk call holds at once


class Draw(NamedTuple):
    name: str
    shape: tuple
    centre: float     # U(centre - half, centre + half); half 0 marks N(0, 1)
    half: float


class VideoBatch(NamedTuple):
    mix: torch.Tensor       # (B, N)
    sources: torch.Tensor   # (B, K, N)
    spk_idx: torch.Tensor   # (B, K)
    frames: torch.Tensor    # (B, K, T, H, W, 3) uint8, a clip a channel


def trunk_spec() -> List[Draw]:
    """Convolutions at the ReLU-preserving scale U(+-sqrt(6 / fan_in)),
    the folded batch norm's scale near 1 and shift near 0 (so that it is
    not the identity), the linear layers at U(+-1/sqrt(fan_in))."""
    out = []
    for name, cin, cout, kh, kw, _ in inception.convolutions():
        p = f"{TRUNK}{name}"
        out += [Draw(f"{p}.w", (kh, kw, cin, cout), 0.0,
                     math.sqrt(6.0 / (kh * kw * cin))),
                Draw(f"{p}.scale", (cout,), 1.0, 0.1),
                Draw(f"{p}.shift", (cout,), 0.0, 0.1)]
    for name, cin, cout in inception.FC:
        s = cin ** -0.5
        out += [Draw(f"{TRUNK}{name}.w", (cin, cout), 0.0, s),
                Draw(f"{TRUNK}{name}.b", (cout,), 0.0, s)]
    return out


def param_spec_video(c: dict) -> List[Draw]:
    """Every leaf of the separator with its video query, in a fixed
    order: the separator's as `params.param_spec` draws them, the
    trunk's, the BiLSTM's, the dense and logit layers'."""
    h, e = c["hidden_units"], c["embedding_size"]
    leaves = (_rnn("video_query.rnn", "lstm", inception.FEATURE, h,
                   c["num_layers"])
              + _linear("video_query.dense", 2 * h, e)
              + _linear("video_query.logits", e, c["num_speakers"]))
    return ([Draw(l.name, l.shape, 0.0, l.scale) for l in param_spec(c)]
            + trunk_spec()
            + [Draw(l.name, l.shape, 0.0, l.scale) for l in leaves])


def make_params(c: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of `seed`, made on `device` by one generator there
    (one uniform draw, then one normal draw), float32."""
    spec = param_spec_video(c)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_u = sum(math.prod(d.shape) for d in spec if d.half)
    n_n = sum(math.prod(d.shape) for d in spec if not d.half)
    uni = torch.rand(n_u, generator=gen, device=device) * 2.0 - 1.0
    nor = torch.randn(n_n, generator=gen, device=device)
    out, iu, inn = {}, 0, 0
    for d in spec:
        n = math.prod(d.shape)
        if d.half:
            out[d.name] = (d.centre + d.half * uni[iu:iu + n]).view(d.shape)
            iu += n
        else:
            out[d.name] = nor[inn:inn + n].view(d.shape).clone()
            inn += n
    return out


def trunk_names(params) -> List[str]:
    return [n for n in params if n.startswith(TRUNK)]


def video_query(p, frames: torch.Tensor, c: dict):
    """frames (N, T, H, W, 3) uint8 -> (logits (N, S), query (N, E))."""
    n, t = frames.shape[:2]
    x = inception.features_in_blocks(
        p, TRUNK, frames.reshape((n * t,) + frames.shape[2:]), BLOCK)
    h = rnn.stack(p, "video_query.rnn", x.reshape(n, t, -1), "lstm",
                  c["num_layers"])
    q = torch.matmul(h[:, -1], p["video_query.dense.w"]) \
        + p["video_query.dense.b"]
    logits = torch.matmul(q, p["video_query.logits.w"]) \
        + p["video_query.logits.b"]
    return logits, q


def query_loss(p, mix, src, spk_idx, frames, c: dict) -> torch.Tensor:
    """PIT MSE of the masks the video queries draw, plus the queries'
    speaker cross-entropy."""
    b, k = spk_idx.shape
    logits, q = video_query(p, frames.reshape((b * k,) + frames.shape[2:]),
                            c)
    hidden = model.encoder_hidden(p, mix, c)
    queries = q.reshape(b, k, -1)
    if c["is_self_tune"]:
        queries = model.adjust(p, hidden, queries)
    masks = model.mask_head(p, hidden, queries, c)
    return (train.pit_mse(masks * mix[:, None], src)
            + F.cross_entropy(logits, spk_idx.reshape(-1)))


def query_step(params, opt: train.Adam, batch: VideoBatch, c: dict):
    """One step: `query_loss`, clipped Adam. Returns (loss, the gradients
    as the optimizer gets them, before its clip)."""
    mix, src = train.features(batch, c)
    with torch.enable_grad():
        leaves = {n: params[n].detach().requires_grad_() for n in opt.names}
        loss = query_loss(dict(params, **leaves), mix, src, batch.spk_idx,
                          batch.frames, c)
        grads = train._grads(loss, leaves, opt.names)
    opt.update(params, grads)
    return float(loss.detach()), grads


def query_late(params, batch: VideoBatch, c: dict):
    """The step's loss at `params` on `batch`, without the step."""
    mix, src = train.features(batch, c)
    with torch.no_grad():
        return (float(query_loss(params, mix, src, batch.spk_idx,
                                 batch.frames, c)),)
