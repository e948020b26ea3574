"""The parameters of a configuration: their names, shapes and initial
distribution, and the weights made from a seed.

Names and layouts are the ones both sides load: a recurrent cell keeps
`wx (D, G*H)`, `wh (H, G*H)`, `bx`, `bh (G*H,)` with torch's gate order
(LSTM i, f, g, o; GRU r, z, n), a linear layer `w (in, out)` and `b`, a
convolution `w` as (kh, kw, in, out). The initial scales are the usual
torch ones: U(-1/sqrt(fan), 1/sqrt(fan)); the speaker table is N(0, 1).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

GATES = {"gru": 3, "lstm": 4}


class Leaf(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    scale: float          # U(-scale, scale); 0 marks N(0, 1)


def freq_bins(c: dict) -> int:
    return c["frame_length"] // 2 + 1


def num_frames(c: dict) -> int:
    return 1 + c["max_len"] // c["frame_shift"]


def disc_out_hw(t: int, f: int) -> Tuple[int, int]:
    """Spatial size after three 3x3 stride-2 VALID convolutions."""
    for _ in range(3):
        t, f = (t - 3) // 2 + 1, (f - 3) // 2 + 1
    return t, f


def _rnn(prefix: str, cell: str, d_in: int, hidden: int, layers: int
         ) -> List[Leaf]:
    g = GATES[cell] * hidden
    s = hidden ** -0.5
    out, d = [], d_in
    for layer in range(layers):
        for direction in ("fwd", "bwd"):
            p = f"{prefix}.{layer}.{direction}"
            out += [Leaf(f"{p}.wx", (d, g), s), Leaf(f"{p}.wh", (hidden, g), s),
                    Leaf(f"{p}.bx", (g,), s), Leaf(f"{p}.bh", (g,), s)]
        d = 2 * hidden
    return out


def _linear(prefix: str, d_in: int, d_out: int, bias: bool = True
            ) -> List[Leaf]:
    s = d_in ** -0.5
    out = [Leaf(f"{prefix}.w", (d_in, d_out), s)]
    return out + [Leaf(f"{prefix}.b", (d_out,), s)] if bias else out


def param_spec(c: dict) -> List[Leaf]:
    """Every leaf of the configuration's separator, in a fixed order."""
    f, h, e = freq_bins(c), c["hidden_units"], c["embedding_size"]
    hc = h * c["classifier_hidden_mult"]
    s = c["num_speakers"]
    spec = _rnn("encoder.rnn", c["encoder_rnn"], f, h, c["encoder_layers"])
    spec += _linear("encoder.proj", 2 * h, f * e)
    spec += _rnn("classifier.rnn", c["classifier_rnn"], f, hc,
                 c["classifier_layers"])
    spec += _linear("classifier.out", 2 * hc, s)
    spec.append(Leaf("embedding.table", (s, e), 0.0))
    if c["is_self_tune"]:
        spec += _linear("adjust.layer", 2 * h + e, e, bias=False)
    if c["use_discriminator"]:
        for i, cin in enumerate((1, 64, 64)):
            sc = (cin * 9) ** -0.5
            spec += [Leaf(f"discriminator.conv{i}.w", (3, 3, cin, 64), sc),
                     Leaf(f"discriminator.conv{i}.b", (64,), sc)]
        th, fw = disc_out_hw(num_frames(c), f)
        spec += _linear("discriminator.out", th * fw * 64, 1)
    return spec


def make_params(c: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of `seed`, made on `device` in two calls of one
    generator there (one uniform draw for every scaled leaf, one normal
    draw for the tables), float32."""
    spec = param_spec(c)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_u = sum(_numel(l.shape) for l in spec if l.scale)
    n_n = sum(_numel(l.shape) for l in spec if not l.scale)
    uni = torch.rand(n_u, generator=gen, device=device) * 2.0 - 1.0
    nor = torch.randn(n_n, generator=gen, device=device)
    out, iu, inn = {}, 0, 0
    for leaf in spec:
        n = _numel(leaf.shape)
        if leaf.scale:
            out[leaf.name] = (uni[iu:iu + n] * leaf.scale).view(leaf.shape)
            iu += n
        else:
            out[leaf.name] = nor[inn:inn + n].view(leaf.shape).clone()
            inn += n
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n
