"""The separator: encoder, speaker queries, self-tune, dot mask head and
mask apply; the speaker classifier; TDAA's discriminator.

The mask head computes at the precision the configuration file states
under `precision.mask_head` ("bfloat16_operands"): the hidden states, the
projection and the queries rounded to bfloat16, the projection accumulated
in float32 and tanh in float32, each product of the tanh grid with a query
rounded to bfloat16 before the float32 sum over the embedding; its
backward rounds to bfloat16 where its forward does (`_DotHead`).
Everything else is float32.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from benchmark.reference import rnn
from benchmark.reference.dsp import istft
from benchmark.reference.params import freq_bins

Params = Dict[str, torch.Tensor]
DQ_TILE = 64        # frames over which dq's partial sums are rounded


class Separated(NamedTuple):
    masks: torch.Tensor     # (B, K, T, F)
    pred: torch.Tensor      # masks * |X|


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def encoder_hidden(p: Params, feat: torch.Tensor, c: dict) -> torch.Tensor:
    return rnn.stack(p, "encoder.rnn", feat, c["encoder_rnn"],
                     c["encoder_layers"])


class _DotHead(torch.autograd.Function):
    """The dot mask head at the stated precision, forward and backward.

    Backward, on the masks and their gradient rounded to bf16:
    de = bf16(dmask * m (1 - m)); dg = sum_k de_k q_k;
    dacc = bf16(dg (1 - g^2)); dh = dacc W16^T and dW = h16^T dacc in
    float32; db = sum dacc; dq_k = sum over 64-frame tiles of the tile's
    bf16-rounded sums of g de_k."""

    @staticmethod
    def forward(ctx, hidden, w, b, queries, f, e):
        bsz, t, _ = hidden.shape
        h16, w16, q = _bf16(hidden), _bf16(w), _bf16(queries)
        g = torch.tanh(torch.matmul(h16, w16) + b).reshape(bsz, t, f, e)
        masks = torch.sigmoid(torch.stack(
            [_bf16(g * q[:, k, None, None, :]).sum(-1)
             for k in range(q.shape[1])], dim=1))
        ctx.save_for_backward(h16, w16, g, q, masks)
        return masks

    @staticmethod
    def backward(ctx, dmask):
        h16, w16, g, q, masks = ctx.saved_tensors
        bsz, t, f, e = g.shape
        m = _bf16(masks)
        de = _bf16(_bf16(dmask) * m * (1.0 - m))                 # (B,K,T,F)
        dg = torch.einsum("bktf,bke->btfe", de, q)
        dacc = _bf16(dg * (1.0 - g * g)).reshape(bsz, t, f * e)
        tiles = -(-t // DQ_TILE)
        pad = tiles * DQ_TILE - t
        gt = F.pad(g, (0, 0, 0, 0, 0, pad)).reshape(bsz, tiles, DQ_TILE, f, e)
        det = F.pad(de, (0, 0, 0, pad)).reshape(bsz, -1, tiles, DQ_TILE, f)
        dq = _bf16(torch.einsum("bntfe,bkntf->bknfe", gt, det)).sum(
            dim=(2, 3))
        dh = torch.matmul(dacc, w16.T)
        dw = torch.matmul(h16.reshape(-1, h16.shape[-1]).T,
                          dacc.reshape(-1, f * e))
        return dh, dw, dacc.sum(dim=(0, 1)), dq, None, None


def mask_head(p: Params, hidden: torch.Tensor, queries: torch.Tensor,
              c: dict) -> torch.Tensor:
    """hidden (B, T, 2H), queries (B, K, E) -> sigmoid masks (B, K, T, F)."""
    if c["precision"]["mask_head"] != "bfloat16_operands":
        raise ValueError(f"unknown mask-head precision "
                         f"{c['precision']['mask_head']!r}")
    return _DotHead.apply(hidden, p["encoder.proj.w"], p["encoder.proj.b"],
                          queries, freq_bins(c), c["embedding_size"])


def adjust(p: Params, hidden: torch.Tensor, queries: torch.Tensor
           ) -> torch.Tensor:
    ctx = hidden.mean(dim=1)[:, None, :].expand(-1, queries.shape[1], -1)
    return queries + torch.matmul(torch.cat([ctx, queries], dim=-1),
                                  p["adjust.layer.w"])


def classifier_probs(p: Params, feat: torch.Tensor, c: dict) -> torch.Tensor:
    """feat (B, T, F) -> speaker presence probabilities (B, S)."""
    hidden = rnn.stack(p, "classifier.rnn", feat, c["classifier_rnn"],
                       c["classifier_layers"])
    logits = (torch.matmul(hidden.mean(dim=1), p["classifier.out.w"])
              + p["classifier.out.b"])
    return torch.sigmoid(logits)


def separate(p: Params, feat: torch.Tensor, spk_idx: torch.Tensor, c: dict
             ) -> Separated:
    """feat (B, T, F) magnitudes, spk_idx (B, K) -> masks and masked
    magnitudes of the K speakers."""
    hidden = encoder_hidden(p, feat, c)
    queries = p["embedding.table"][spk_idx]
    if c["is_self_tune"]:
        queries = adjust(p, hidden, queries)
    masks = mask_head(p, hidden, queries, c)
    return Separated(masks, masks * feat[:, None])


def discriminator(p: Params, specs: torch.Tensor) -> torch.Tensor:
    """specs (B, K, T, F) -> realness (B*K, 1): three 3x3 stride-2 VALID
    convolutions of 64 channels with ReLU, flattened in (T, F, channel)
    order, a linear layer and a sigmoid."""
    b, k, t, f = specs.shape
    x = specs.reshape(b * k, 1, t, f)
    for i in range(3):
        w = p[f"discriminator.conv{i}.w"].permute(3, 2, 0, 1)
        x = torch.relu(F.conv2d(x, w, p[f"discriminator.conv{i}.b"],
                                stride=2))
    x = x.permute(0, 2, 3, 1).reshape(b * k, -1)
    return torch.sigmoid(torch.matmul(x, p["discriminator.out.w"])
                         + p["discriminator.out.b"])


def top_k(probs: torch.Tensor, k: int) -> torch.Tensor:
    return torch.topk(probs, k, dim=-1).indices


def resynthesise(masks: torch.Tensor, spec: torch.Tensor, c: dict,
                 length: Optional[int] = None) -> torch.Tensor:
    """masks (B, K, T, F) on the mixture spectrum (B, T, F) -> (B, K, N)."""
    return istft(masks * spec[:, None], c["frame_length"], c["frame_shift"],
                 length)
