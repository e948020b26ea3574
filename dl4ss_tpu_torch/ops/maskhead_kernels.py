"""K3, the fused projection + dot-attention mask head: CUDA kernel and plain
version.

Ports `fused_dot_masks`' forward (dl4ss_tpu/ops/pallas_maskhead.py). The
kernel always computes at tensor-core precision, as the JAX kernel does at
MXU precision: h, W and q in bf16, f32 accumulation, tanh in f32, the g*q
product rounded to bf16 before the E-sum in f32; the plain version rounds
at the same points. CPU tensors go to the plain version, CUDA tensors to
csrc/maskhead_fwd.cu; there is no fallback between them. On the card W is
packed into the kernel's tile layout once per version of W (the layout
lives in the .cu file alone) and the packed copy is kept while W lives.
"""

from __future__ import annotations

import torch
from torch.utils.weak import WeakIdKeyDictionary

from dl4ss_tpu_torch.ops import cuda_lib

_OUT_DTYPES = (torch.float32, torch.bfloat16)
_W_DTYPES = (torch.float32, torch.bfloat16)
# W -> ((version, data pointer, F, E), packed W), dropped with W
_PACKED = WeakIdKeyDictionary()


def fused_dot_masks(hidden: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    queries: torch.Tensor, freq_bins: int, emb: int
                    ) -> torch.Tensor:
    """hidden (B, T, 2H), w (2H, F*E), b (F*E,), queries (B, K, E) ->
    sigmoid dot-attention masks (B, K, T, F) in hidden's dtype, without the
    (B, T, F, E) embedding grid."""
    bsz, t, h2 = hidden.shape
    fe = freq_bins * emb
    if tuple(w.shape) != (h2, fe) or tuple(b.shape) != (fe,):
        raise ValueError(f"fused_dot_masks: w {tuple(w.shape)} / b "
                         f"{tuple(b.shape)} do not match hidden width {h2} "
                         f"and F*E={fe}")
    if queries.shape[0] != bsz or queries.shape[2] != emb:
        raise ValueError(f"fused_dot_masks: queries {tuple(queries.shape)} "
                         f"must be (B={bsz}, K, E={emb})")
    args = (hidden.to(torch.bfloat16).contiguous(), w.contiguous(),
            b.float().contiguous(), queries.to(torch.bfloat16).contiguous(),
            freq_bins, emb, hidden.dtype)
    if hidden.is_cuda:
        return fused_dot_masks_cuda(*args)
    return fused_dot_masks_plain(*args)


def fused_dot_masks_plain(h, w, b, q, freq_bins: int, emb: int, out_dtype
                          ) -> torch.Tensor:
    """K3's plain version on bf16 h and q (W is rounded to bf16 here): the
    rounding points of the kernel, with the embedding grid materialised."""
    bsz, t, _ = h.shape
    g = torch.tanh(torch.matmul(h.float(), w.to(torch.bfloat16).float()) + b)
    g = g.reshape(bsz, t, freq_bins, emb)
    gq = (g[:, None] * q.float()[:, :, None, None, :]).to(torch.bfloat16)
    return torch.sigmoid(gq.float().sum(-1)).to(out_dtype)


def pack_w(w: torch.Tensor, freq_bins: int, emb: int) -> torch.Tensor:
    """W (D, F*E), f32 or bf16, on the card -> the kernel's packed bf16
    tiles, in one pass (csrc/maskhead_fwd.cu, `dl4ss_maskhead_pack`)."""
    d = w.shape[0]
    cuda_lib.check(w, "w", _W_DTYPES, (d, freq_bins * emb))
    n = cuda_lib.query("maskhead_packed_size", d, freq_bins, emb)
    if n < 0:
        raise ValueError(f"fused_dot_masks: embedding width {emb} is outside "
                         f"the kernel's 1..256")
    wt = torch.empty((n,), dtype=torch.bfloat16, device=w.device)
    cuda_lib.launch("maskhead_pack", w.device, w, wt, d, freq_bins, emb,
                    int(w.dtype == torch.float32))
    return wt


def _packed(w: torch.Tensor, freq_bins: int, emb: int) -> torch.Tensor:
    """`pack_w(w)`, built once per version of W (an in-place update of W
    repacks it). Inference tensors keep no version: they pack every call."""
    if w.is_inference():
        return pack_w(w, freq_bins, emb)
    key = (w._version, w.data_ptr(), freq_bins, emb)
    hit = _PACKED.get(w)
    if hit is None or hit[0] != key:
        hit = _PACKED[w] = (key, pack_w(w, freq_bins, emb))
    return hit[1]


def fused_dot_masks_cuda(h, w, b, q, freq_bins: int, emb: int, out_dtype
                         ) -> torch.Tensor:
    """K3 on the card: csrc/maskhead_fwd.cu, on h (B, T, D) in its own
    layout and W packed once per version (`_packed`)."""
    bsz, t, h2 = h.shape
    k = q.shape[1]
    fe = freq_bins * emb
    cuda_lib.check(h, "hidden", (torch.bfloat16,))
    cuda_lib.check(w, "w", _W_DTYPES, (h2, fe))
    cuda_lib.check(b, "b", (torch.float32,), (fe,))
    cuda_lib.check(q, "queries", (torch.bfloat16,), (bsz, k, emb))
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {_OUT_DTYPES}")
    wt = _packed(w, freq_bins, emb)
    out = torch.empty((bsz, k, t, freq_bins), dtype=out_dtype,
                      device=h.device)
    cuda_lib.launch("maskhead_fwd", h.device, h, wt, b, q, out, bsz, t, h2,
                    freq_bins, emb, k, int(out_dtype == torch.bfloat16))
    return out
