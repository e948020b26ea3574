"""DPRNN-TasNet (Luo, Chen and Yoshioka, arXiv:1910.06379, sections 2-4)
and its training step, in float32, written out: the encoder as shifted
slices times the filter bank, gLN from its definition, segmentation and
overlap-add by explicit slices, each BiLSTM as the step loop of
`reference/rnn.py`, the decoder as each frame's filter response added at
its samples, SI-SNR under utterance-level PIT over the permutations, and
`reference/train.py`'s clipped Adam.

`m` is the configuration file's `model` block: filters N, kernel L (stride
L/2), bottleneck D, hidden H, blocks R, chunk K, hop P, speakers C.
Parameters are named as the program's `models/dprnn.py` names them; the
initial scales are torch's (a filter bank of L taps U(-1/sqrt(L),
1/sqrt(L)), a linear layer U(-1/sqrt(in), 1/sqrt(in)), gLN's gamma ones
and beta zeros, the PReLU's slope 0.25).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Tuple

import torch

from benchmark.reference import rnn
from benchmark.reference.params import Leaf, _linear, _numel, _rnn
from benchmark.reference.train import Adam

EPS = 1e-8          # gLN's
CONSTANTS = {"gamma": 1.0, "beta": 0.0, "a": 0.25}


def param_spec(m: dict) -> List[Leaf]:
    """Every leaf in a fixed order; a leaf of scale 0 takes its value from
    CONSTANTS by its last name."""
    n, d, h = m["filters"], m["bottleneck"], m["hidden"]

    def norm(prefix, ch):
        return [Leaf(f"{prefix}.gamma", (ch,), 0.0),
                Leaf(f"{prefix}.beta", (ch,), 0.0)]

    spec = [Leaf("encoder.w", (n, m["kernel"]), m["kernel"] ** -0.5)]
    spec += norm("norm", n) + _linear("bottleneck", n, d)
    for r in range(m["blocks"]):
        for half in ("intra", "inter"):
            p = f"blocks.{r}.{half}"
            spec += (_rnn(f"{p}.rnn", "lstm", d, h, 1)
                     + _linear(f"{p}.proj", 2 * h, d) + norm(f"{p}.norm", d))
    spec.append(Leaf("prelu.a", (1,), 0.0))
    spec += _linear("mask", d, m["speakers"] * n)
    spec.append(Leaf("decoder.w", (n, m["kernel"]), m["kernel"] ** -0.5))
    return spec


def make_params(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of `seed`, made on `device` by one uniform draw of a
    generator there, float32."""
    spec = param_spec(m)
    gen = torch.Generator(device=device).manual_seed(seed)
    uni = torch.rand(sum(_numel(l.shape) for l in spec if l.scale),
                     generator=gen, device=device) * 2.0 - 1.0
    out, i = {}, 0
    for leaf in spec:
        if leaf.scale:
            k = _numel(leaf.shape)
            out[leaf.name] = (uni[i:i + k] * leaf.scale).view(leaf.shape)
            i += k
        else:
            out[leaf.name] = torch.full(leaf.shape,
                                        CONSTANTS[leaf.name.split(".")[-1]],
                                        device=device)
    return out


def gln(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor
        ) -> torch.Tensor:
    """x (B, ..., C): each sample to zero mean and unit variance over all
    its entries, then gamma * x + beta per channel."""
    dims = tuple(range(1, x.dim()))
    mean = x.mean(dim=dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS) * gamma + beta


def padding(frames: int, m: dict) -> Tuple[int, int]:
    """P zeros in front; behind, the fewest of at least P that make the
    padded length less K a multiple of P."""
    k, p = m["chunk"], m["hop"]
    back = p
    while (frames + p + back - k) % p:
        back += 1
    return p, back


def segment(y: torch.Tensor, m: dict) -> torch.Tensor:
    """(B, T', D) -> (B, S, K, D), chunk s the padded frames s*P onward."""
    b, frames, d = y.shape
    front, back = padding(frames, m)
    yp = torch.cat([y.new_zeros((b, front, d)), y,
                    y.new_zeros((b, back, d))], dim=1)
    k, p = m["chunk"], m["hop"]
    s = (yp.shape[1] - k) // p + 1
    return torch.stack([yp[:, i * p:i * p + k] for i in range(s)], dim=1)


def overlap_add(z: torch.Tensor, frames: int, m: dict) -> torch.Tensor:
    """(B, S, K, F) -> (B, T', F): each chunk added at its frames, the
    padding cut off."""
    b, s, k, f = z.shape
    front, back = padding(frames, m)
    out = z.new_zeros((b, frames + front + back, f))
    p = m["hop"]
    for i in range(s):
        out[:, i * p:i * p + k] += z[:, i]
    return out[:, front:front + frames]


def _path(params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    """x (B, rows, steps, D) -> x + gLN(Linear(BiLSTM over the steps))."""
    b, rows, steps, d = x.shape
    h = rnn.layer(params, f"{prefix}.rnn.0", x.reshape(b * rows, steps, d),
                  "lstm")
    u = h @ params[f"{prefix}.proj.w"] + params[f"{prefix}.proj.b"]
    return x + gln(u.reshape(b, rows, steps, d),
                   params[f"{prefix}.norm.gamma"],
                   params[f"{prefix}.norm.beta"])


def separate(params, mix: torch.Tensor, m: dict) -> torch.Tensor:
    """mix (B, T) -> the speakers' waveforms (B, C, T)."""
    b, samples = mix.shape
    length, stride, n = m["kernel"], m["kernel"] // 2, m["filters"]
    frames = (samples - length) // stride + 1
    taps = torch.stack([mix[:, l:l + stride * (frames - 1) + 1:stride]
                        for l in range(length)], dim=-1)        # (B, T', L)
    w = torch.relu(taps @ params["encoder.w"].T)               # (B, T', N)
    y = (gln(w, params["norm.gamma"], params["norm.beta"])
         @ params["bottleneck.w"] + params["bottleneck.b"])
    chunks = segment(y, m)                                     # (B, S, K, D)
    for r in range(m["blocks"]):
        chunks = _path(params, f"blocks.{r}.intra", chunks)
        chunks = _path(params, f"blocks.{r}.inter",
                       chunks.transpose(1, 2)).transpose(1, 2)
    act = torch.where(chunks >= 0, chunks, params["prelu.a"] * chunks)
    z = act @ params["mask.w"] + params["mask.b"]
    masks = torch.sigmoid(overlap_add(z, frames, m))           # (B, T', CN)
    masks = masks.reshape(b, frames, m["speakers"], n)
    resp = (masks * w[:, :, None]) @ params["decoder.w"]       # (B,T',C,L)
    out = mix.new_zeros((b, m["speakers"], samples))
    for l in range(length):
        out[:, :, l:l + stride * (frames - 1) + 1:stride] += \
            resp[..., l].transpose(1, 2)
    return out


def si_snr(est: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """SI-SNR in dB over the last axis, of the zero-mean signals."""
    est = est - est.mean(dim=-1, keepdim=True)
    ref = ref - ref.mean(dim=-1, keepdim=True)
    target = ((est * ref).sum(-1, keepdim=True)
              / (ref * ref).sum(-1, keepdim=True)) * ref
    noise = est - target
    return 10.0 * torch.log10((target * target).sum(-1)
                              / (noise * noise).sum(-1))


def upit_snr(est: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(B,): the best permutation's mean SI-SNR over the speakers."""
    c = est.shape[1]
    scores = [torch.stack([si_snr(est[:, i], ref[:, j])
                           for i, j in enumerate(perm)]).mean(0)
              for perm in itertools.permutations(range(c))]
    return torch.stack(scores, -1).max(dim=-1).values


def loss(params, batch, m: dict) -> torch.Tensor:
    """The mean over the batch of the negative uPIT SI-SNR."""
    return -upit_snr(separate(params, batch.mix, m), batch.sources).mean()


def optimizer(params, c: dict) -> Adam:
    return Adam(params, list(params), c)


def tasnet_step(params, opt: Adam, batch, m: dict):
    """One step: the loss and its gradient, then the clipped Adam update
    in place. Returns (loss, the gradients as the optimizer gets them)."""
    with torch.enable_grad():
        leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
        value = loss(leaves, batch, m)
        grads = dict(zip(leaves, torch.autograd.grad(
            value, list(leaves.values()))))
    opt.update(params, grads)
    return float(value.detach()), grads


def tasnet_late(params, batch, m: dict) -> Tuple[float]:
    """The step's loss at `params` on `batch`, without the step."""
    with torch.no_grad():
        return (float(loss(params, batch, m)),)
