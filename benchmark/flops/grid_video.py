"""grid_video's layers, counted from shapes: the separator, counted as
torch_multi's (the same BiGRU encoder, projection and dot mask head); the
video query, a 2-layer BiLSTM over each clip's frames with its dense and
logit layers; and the frozen Inception-v3 trunk, every convolution of it
layer by layer at the configuration's frame size (`video` in its file).
The trunk runs forward only; its pools, concatenations and folded batch
norm are elementwise and not counted."""

from __future__ import annotations

from typing import List, Tuple

from benchmark.harness import flopcount as fc
from benchmark.harness import registry
from benchmark.reference import inception


def video() -> dict:
    """The configuration file's `video` block."""
    return registry.load_json("configs", "grid_video")["video"]


def separator(c: dict, b: int) -> fc.Count:
    return registry.load_module("flops", "torch_multi").separator(c, b)


def video_query(c: dict, clips: int, frames: int) -> fc.Count:
    """The BiLSTM over `clips` clips of `frames` trunk features, the
    dense layer and the logits: one forward."""
    h, e = c["hidden_units"], c["embedding_size"]
    ops, rec = fc.rnn_stack("lstm", clips, frames, inception.FEATURE, h,
                            c["num_layers"], fc.operand_bytes(c))
    return fc.Count(ops + fc.linear(clips, 2 * h, e)
                    + fc.linear(clips, e, c["num_speakers"]), rec)


def _out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def trunk_layers(hw) -> List[Tuple[str, float, float]]:
    """(name, operations, bytes) of each convolution for one frame of
    `hw` pixels: 2 operations a multiply-add; its input read and its
    output written once in float32, its weights once (counted a frame
    here, a negligible share at thousands of frames)."""
    h, w = hw
    out = []

    def conv(layer, h, w):
        name, cin, cout, kh, kw, stride = layer
        ph, pw = inception.padding(name, kh, kw, stride)
        ho, wo = _out(h, kh, stride, ph), _out(w, kw, stride, pw)
        ops = 2.0 * ho * wo * cout * cin * kh * kw
        nbytes = 4.0 * (h * w * cin + ho * wo * cout + kh * kw * cin * cout)
        out.append((name, ops, nbytes))
        return ho, wo

    def pool(h, w):
        return _out(h, 3, 2, 0), _out(w, 3, 2, 0)

    for layer in inception.STEM:
        h, w = pool(h, w) if layer == "pool" else conv(layer, h, w)
    for kind, layers in inception.BLOCKS.values():
        sizes = [conv(layer, h, w) for layer in layers]
        if kind in ("B", "D"):
            # grid reductions: the branches' last, strided, convolutions
            # set the size (as the max pool beside them does)
            h, w = sizes[-1]
    return out


def trunk(c: dict, b: int) -> Tuple[float, float]:
    """(operations, bytes) of the trunk in a step of `b` mixtures: the
    frames of every channel's clip."""
    v = video()
    frames = b * c["max_mix"] * v["frames"]
    layers = trunk_layers(v["frame_hw"])
    return (frames * sum(o for _, o, _ in layers),
            frames * sum(n for _, _, n in layers))


def trunk_least_s(c: dict, b: int, flops: float, bytes_per_s: float
                  ) -> float:
    """The least time of the trunk's convolutions in a step of `b`
    mixtures: layer by layer, the larger of its operations at `flops` and
    its bytes at `bytes_per_s`."""
    v = video()
    frames = b * c["max_mix"] * v["frames"]
    return frames * sum(max(o / flops, n / bytes_per_s)
                        for _, o, n in trunk_layers(v["frame_hw"]))
