"""Target-speaker extraction with the life-long speaker memory (DL4SS
Cocktail/software/DL4SS_Keras, nnet.py and extend_layers.py): the model,
its memory and its training step in plain PyTorch, float32.

One step on a batch of mixtures whose first speaker is the target:
  * the mixture's magnitudes through the NUM_LAYERS BiLSTM encoder, then a
    tanh Dense to the (T, F, E) grid (nnet.py:31-62);
  * the target's clean magnitudes through the BiLSTM(E/2) voiceprint
    stack, mean-pooled over its frames that are not all zero (Masking,
    MeanPool; nnet.py:66-71, extend_layers.py:105-129);
  * the voiceprint written into the target's memory row inside the graph
    (SpkLifeLongMemory, extend_layers.py:132-179): L2-normalised with the
    zero guard (an element that is exactly zero counts as np.spacing(1) in
    the norm, extend_layers.py:161), added into the row (duplicate ids in
    a batch accumulate, as inc_subtensor does), the row renormalised; the
    rows it starts from carry no gradient; the written row read back
    (SelectSpkMemory, extend_layers.py:188-216) as the query;
  * the additive align head, mask = sigmoid(v . tanh(W1 g + W2 q)) over
    the grid (Attention in align mode, extend_layers.py:50-64);
  * the mask times the mixture's magnitude, MSE against the target's
    magnitude (nnet.py:95, 113);
  * the gradient's global norm clipped at `grad_clip_norm`, then Nadam
    (nnet.py:23);
  * then the persistent memory written again, outside the gradient
    (update_memory, nnet.py:130-135), its write counts (ages) kept.

Departures from nnet.py, all shared with the program under test:
  * Nadam is optax's (`Nadam` below), not Keras 1.x's, whose momentum
    follows a schedule (schedule_decay);
  * the out-of-graph write takes the voiceprint of this step's forward,
    computed before the update; nnet.py:133 runs a second forward of the
    voiceprint branch after `train_on_batch`;
  * the memory holds three slots a row (voice, image, video), of which
    this model writes the voice slot alone, and an age a slot;
  * the gates and layouts of the recurrences are `rnn.py`'s (torch's LSTM:
    gates i, f, g, o, two biases), not Keras 1.x's LSTM (hard sigmoid
    gates, one bias);
  * the features are `train.features`' centred librosa STFT magnitudes.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

import torch

from benchmark.reference import rnn
from benchmark.reference.params import Leaf, _linear, _rnn, freq_bins
from benchmark.reference.train import B1, B2, EPS, Adam, features

Params = Dict[str, torch.Tensor]
SLOTS, VOICE = 3, 0
# np.spacing(1) in float32: the zero guard of the write's norms
SPACING = 2.0 ** -23


class Memory(NamedTuple):
    vectors: torch.Tensor   # (rows, SLOTS, D) float32
    age: torch.Tensor       # (rows, SLOTS) int32, writes a slot has taken


def rows(c: dict) -> int:
    """The speakers, and the unk row when `unk_spk` (extend_layers.py:
    133-136)."""
    return c["num_speakers"] + (1 if c["unk_spk"] else 0)


def voice_width(c: dict) -> int:
    """The voiceprint's width: both directions of a BiLSTM(E/2)."""
    return 2 * max(c["embedding_size"] // 2, 1)


def empty_memory(c: dict, device) -> Memory:
    return Memory(torch.zeros((rows(c), SLOTS, voice_width(c)),
                              device=device),
                  torch.zeros((rows(c), SLOTS), dtype=torch.int32,
                              device=device))


def param_spec(c: dict) -> List[Leaf]:
    """Every leaf of the memory model, in a fixed order: the encoder and
    its projection, the align head (W1, W2, v; no biases) and the
    voiceprint stack."""
    f, h, e = freq_bins(c), c["hidden_units"], c["embedding_size"]
    spec = _rnn("encoder.rnn", "lstm", f, h, c["encoder_layers"])
    spec += _linear("encoder.proj", 2 * h, f * e)
    spec += _linear("mask_head.w_grid", e, e, bias=False)
    spec += _linear("mask_head.w_query", e, e, bias=False)
    spec += _linear("mask_head.v", e, 1, bias=False)
    spec += _rnn("speech_query.rnn", "lstm", f, voice_width(c) // 2,
                 c["num_layers"])
    return spec


def make_params(c: dict, seed: int, device) -> Params:
    """The weights of `seed`, made on `device` in one uniform draw of one
    generator there, each leaf U(-scale, scale), float32."""
    spec = param_spec(c)
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(leaf.shape) for leaf in spec]
    uni = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for leaf, n in zip(spec, sizes):
        out[leaf.name] = (uni[at:at + n] * leaf.scale).view(leaf.shape)
        at += n
    return out


def _guarded_norm(v: torch.Tensor) -> torch.Tensor:
    """The L2 norm over the last axis, each exact zero counted as
    np.spacing(1)."""
    v = torch.where(v == 0.0, torch.full_like(v, SPACING), v)
    return torch.sqrt((v * v).sum(dim=-1, keepdim=True))


def keras_write(memory: Memory, spk: torch.Tensor, vec: torch.Tensor,
                slot: int = VOICE) -> Memory:
    """Each vector of `vec` (B, D), normalised, added into its speaker's
    row of `slot` in batch order; then every row of the slot
    renormalised. Out of place, so a write inside the graph passes the
    gradient to `vec`."""
    incoming = vec / _guarded_norm(vec)
    ids = spk.tolist()
    new = list(memory.vectors[:, slot].unbind(0))
    for i, s in enumerate(ids):
        new[s] = new[s] + incoming[i]
    new = torch.stack(new)
    new = new / _guarded_norm(new)
    vectors = torch.stack([new if k == slot else memory.vectors[:, k]
                           for k in range(SLOTS)], dim=1)
    age = memory.age.clone()
    for s in ids:
        age[s, slot] += 1
    return Memory(vectors, age)


def voiceprint(p: Params, clean: torch.Tensor, c: dict) -> torch.Tensor:
    """clean (B, T, F) magnitudes -> (B, D): the stack's outputs averaged
    over the frames that are not all zero."""
    hidden = rnn.stack(p, "speech_query.rnn", clean, "lstm", c["num_layers"])
    valid = (clean != 0.0).any(dim=-1).to(hidden.dtype)[..., None]
    return (hidden * valid).sum(dim=1) / valid.sum(dim=1).clamp(min=1.0)


def embedding_grid(p: Params, mix: torch.Tensor, c: dict) -> torch.Tensor:
    """mix (B, T, F) -> the encoder's tanh grid (B, T, F, E)."""
    b, t, f = mix.shape
    hidden = rnn.stack(p, "encoder.rnn", mix, "lstm", c["encoder_layers"])
    grid = torch.tanh(torch.matmul(hidden, p["encoder.proj.w"])
                      + p["encoder.proj.b"])
    return grid.reshape(b, t, f, c["embedding_size"])


def align_mask(p: Params, grid: torch.Tensor, query: torch.Tensor
               ) -> torch.Tensor:
    """grid (B, T, F, E), query (B, E) -> sigmoid(v . tanh(W1 g + W2 q))
    (B, T, F)."""
    g = torch.matmul(grid, p["mask_head.w_grid.w"])
    q = torch.matmul(query, p["mask_head.w_query.w"])
    s = torch.tanh(g + q[:, None, None, :])
    return torch.sigmoid(torch.matmul(s, p["mask_head.v.w"])[..., 0])


def loss_and_voiceprint(p: Params, memory: Memory, batch, c: dict
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step's loss at `p` and `memory`, and the voiceprint it wrote."""
    mix, src = features(batch, c)
    target = src[:, 0]
    spk = batch.spk_idx[:, 0]
    vp = voiceprint(p, target, c)
    start = Memory(memory.vectors.detach(), memory.age)
    query = keras_write(start, spk, vp).vectors[spk, VOICE]
    mask = align_mask(p, embedding_grid(p, mix, c), query)
    return ((mask * mix - target) ** 2).mean(), vp


class Nadam(Adam):
    """optax.nadam behind the global-norm clip: Adam's moments, and the
    Nesterov step b1 mu / (1 - b1^(n+1)) + (1 - b1) g / (1 - b1^n) in
    place of mu / (1 - b1^n)."""

    @torch.no_grad()
    def update(self, params: Params, grads: Params) -> None:
        norm = math.sqrt(sum(float((grads[n].double() ** 2).sum())
                             for n in self.names))
        clip = self.c["grad_clip_norm"]
        factor = clip / norm if clip and norm >= clip else 1.0
        lr = self.lr()
        self.count += 1
        k = self.count
        for n in self.names:
            g = grads[n] * factor
            self.mu[n] += (1.0 - B1) * (g - self.mu[n])
            self.nu[n] = B2 * self.nu[n] + (1.0 - B2) * g * g
            mu_hat = (B1 * self.mu[n] / (1.0 - B1 ** (k + 1))
                      + (1.0 - B1) * g / (1.0 - B1 ** k))
            nu_hat = self.nu[n] / (1.0 - B2 ** k)
            params[n] -= lr * mu_hat / (torch.sqrt(nu_hat) + EPS)


def optimizer(params: Params, c: dict) -> Nadam:
    """The configuration's optimizer over every leaf: Nadam, as nnet.py:23
    compiles the model."""
    if c["optimizer"] != "nadam":
        raise ValueError(f"the memory model trains with nadam, not "
                         f"{c['optimizer']!r}")
    return Nadam(params, list(params), c)


def memory_step(params: Params, opt: Nadam, memory: Memory, batch, c: dict
                ) -> Tuple[float, Params, Memory]:
    """One step: the loss through the in-graph write, its gradient, the
    clipped update of `params` in place, then the out-of-graph write.
    Returns (loss, the gradients as the optimizer gets them, before its
    clip, the memory after the step)."""
    with torch.enable_grad():
        leaves = {n: params[n].detach().requires_grad_() for n in opt.names}
        loss, vp = loss_and_voiceprint(dict(params, **leaves), memory,
                                       batch, c)
        got = torch.autograd.grad(loss, list(leaves.values()),
                                  allow_unused=True)
    grads = {n: torch.zeros_like(leaves[n]) if g is None else g
             for n, g in zip(leaves, got)}
    opt.update(params, grads)
    with torch.no_grad():
        memory = keras_write(memory, batch.spk_idx[:, 0], vp.detach())
    return float(loss.detach()), grads, memory


def memory_late(params: Params, memory: Memory, batch, c: dict):
    """The step's loss at `params` and `memory` on `batch`, without the
    step."""
    with torch.no_grad():
        return (float(loss_and_voiceprint(params, memory, batch, c)[0]),)
