"""K3 and K6, the fused projection + dot-attention mask head and its
backward: CUDA kernels and plain versions.

Ports `fused_dot_masks` (dl4ss_tpu/ops/pallas_maskhead.py) with its custom
VJP. The kernels always compute at tensor-core precision, as the JAX
kernels do at MXU precision: h, W and q in bf16, f32 accumulation, tanh in
f32; the forward rounds the g*q product to bf16 before the E-sum, the
backward rounds de, the per-tile column sums behind dq, and dacc. The plain
versions round at the same points. `fused_dot_masks` is a
`torch.autograd.Function`: CPU tensors go to the plain versions, CUDA
tensors to csrc/maskhead_fwd.cu (K3) and csrc/maskhead_bwd.cu (K6); there
is no fallback between them. On the card W is packed into the kernels'
tile layout once per version of W (the layout lives in the .cu files
alone) and the packed copy is kept while W lives, so a training step's
forward and backward share one pack.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from dl4ss_tpu_torch.ops import cuda_lib

_OUT_DTYPES = (torch.float32, torch.bfloat16)
_W_DTYPES = (torch.float32, torch.bfloat16)
# W -> ((version, data pointer, F, E), packed W), dropped with W
_PACKED = WeakIdKeyDictionary()


# the JAX backward kernel's time tile (`_TILE_T_BWD`), the tile over which
# the column sums behind dq are rounded to bf16; K6 uses the same 64 rows
_DQ_TILE = 64


class _FusedDotMasks(torch.autograd.Function):
    """fused_dot_masks with its VJP: saves (hidden, w, b, queries, masks)
    as `_fwd_vjp` does. K6 (or its plain version) gives dacc and dq; dW,
    dh and db are the plain matrix products JAX also runs outside its
    kernel (pallas_maskhead.py:276-287)."""

    @staticmethod
    def forward(ctx, hidden, w, b, queries, freq_bins, emb):
        args = (hidden.to(torch.bfloat16).contiguous(), w.contiguous(),
                b.float().contiguous(), queries.to(torch.bfloat16).contiguous(),
                freq_bins, emb)
        fwd = fused_dot_masks_cuda if hidden.is_cuda else fused_dot_masks_plain
        masks = fwd(*args, hidden.dtype)
        ctx.save_for_backward(hidden, w, b, queries, masks)
        ctx.dims = (freq_bins, emb)
        return masks

    @staticmethod
    def backward(ctx, dout):
        hidden, w, b, queries, masks = ctx.saved_tensors
        freq_bins, emb = ctx.dims
        h16 = hidden.to(torch.bfloat16).contiguous()
        bwd = (fused_dot_masks_bwd_cuda if hidden.is_cuda
               else fused_dot_masks_bwd_plain)
        dacc, dq = bwd(h16, w.contiguous(), b.float().contiguous(),
                       queries.to(torch.bfloat16).contiguous(),
                       masks.to(torch.bfloat16).contiguous(),
                       dout.to(torch.bfloat16).contiguous(), freq_bins, emb)
        dh, dw, db = dacc_products(h16, w, dacc)
        return (dh.to(hidden.dtype), dw.to(w.dtype), db.to(b.dtype),
                dq.to(queries.dtype), None, None)


def dacc_products(h16, w, dacc) -> Tuple[torch.Tensor, ...]:
    """(dh, dW, db) = (dacc.W^T, h^T.dacc, sum of dacc) over the one bf16
    dacc, in f32: the plain matrix products that JAX also runs outside its
    kernel (pallas_maskhead.py:276-287)."""
    d = h16.shape[-1]
    dacc32 = dacc.float()
    dw = torch.matmul(h16.float().reshape(-1, d).T,
                      dacc32.reshape(-1, dacc.shape[-1]))
    dh = torch.matmul(dacc32, w.to(torch.bfloat16).float().T)
    return dh, dw, dacc32.sum(dim=(0, 1))


def fused_dot_masks(hidden: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    queries: torch.Tensor, freq_bins: int, emb: int,
                    bwd_tile: int = _DQ_TILE) -> torch.Tensor:
    """hidden (B, T, 2H), w (2H, F*E), b (F*E,), queries (B, K, E) ->
    sigmoid dot-attention masks (B, K, T, F) in hidden's dtype, without the
    (B, T, F, E) embedding grid. Differentiable in hidden, w, b and queries.

    `bwd_tile` is the JAX kernel's backward time tile, a VMEM budget with
    no counterpart here: it is accepted and ignored (K6 always takes 64
    rows, as K3 ignores the forward's `_TILE_T`)."""
    del bwd_tile
    bsz, t, h2 = hidden.shape
    fe = freq_bins * emb
    if tuple(w.shape) != (h2, fe) or tuple(b.shape) != (fe,):
        raise ValueError(f"fused_dot_masks: w {tuple(w.shape)} / b "
                         f"{tuple(b.shape)} do not match hidden width {h2} "
                         f"and F*E={fe}")
    if queries.shape[0] != bsz or queries.shape[2] != emb:
        raise ValueError(f"fused_dot_masks: queries {tuple(queries.shape)} "
                         f"must be (B={bsz}, K, E={emb})")
    return _FusedDotMasks.apply(hidden, w, b, queries, freq_bins, emb)


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


def fused_dot_masks_bwd_plain(h, w, b, q, masks, dout, freq_bins: int,
                              emb: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's plain version: `_bwd_kernel`'s math on bf16 h, q, masks and
    dout (W is rounded to bf16 here) -> dacc (B, T, F*E) bf16 and dq
    (B, K, E) f32, the column sums behind dq rounded to bf16 per 64-row
    time tile as in the kernels."""
    bsz, t, _ = h.shape
    k = q.shape[1]
    g = torch.tanh(torch.matmul(h.float(), w.to(torch.bfloat16).float()) + b)
    g = g.reshape(bsz, t, freq_bins, emb)
    m = masks.float()
    de = (dout.float() * m * (1.0 - m)).to(torch.bfloat16).float()
    qf = q.float()
    dg = torch.zeros_like(g)
    for ki in range(k):
        dg = dg + de[:, ki, :, :, None] * qf[:, ki, None, None, :]
    dacc = (dg * (1.0 - g * g)).to(torch.bfloat16).reshape(bsz, t, -1)
    # dq_k[e] = sum over tiles of sum_f bf16(sum_{t in tile} g * de_k)
    tiles = -(-t // _DQ_TILE)
    pad = tiles * _DQ_TILE - t
    gt = torch.nn.functional.pad(g, (0, 0, 0, 0, 0, pad)).reshape(
        bsz, tiles, _DQ_TILE, freq_bins, emb)
    det = torch.nn.functional.pad(de, (0, 0, 0, pad)).reshape(
        bsz, k, tiles, _DQ_TILE, freq_bins)
    col = torch.einsum("bntfe,bkntf->bknfe", gt, det)
    dq = col.to(torch.bfloat16).float().sum(dim=(2, 3))
    return dacc, dq


def fused_dot_masks_bwd_cuda(h, w, b, q, masks, dout, freq_bins: int,
                             emb: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 on the card: csrc/maskhead_bwd.cu on h (B, T, D) in its own
    layout and the W that K3 packed for this version (`_packed`). Same
    contract as `fused_dot_masks_bwd_plain`."""
    bsz, t, h2 = h.shape
    k = q.shape[1]
    fe = freq_bins * emb
    cuda_lib.check(h, "hidden", (torch.bfloat16,))
    cuda_lib.check(w, "w", _W_DTYPES, (h2, fe))
    cuda_lib.check(b, "b", (torch.float32,), (fe,))
    cuda_lib.check(q, "queries", (torch.bfloat16,), (bsz, k, emb))
    cuda_lib.check(masks, "masks", (torch.bfloat16,), (bsz, k, t, freq_bins))
    cuda_lib.check(dout, "dout", (torch.bfloat16,), (bsz, k, t, freq_bins))
    wt = _packed(w, freq_bins, emb)
    n = cuda_lib.query("maskhead_bwd_partials", bsz, t, h2, freq_bins, emb, k)
    dacc = torch.empty((bsz, t, fe), dtype=torch.bfloat16, device=h.device)
    part = torch.empty((n,), dtype=torch.float32, device=h.device)
    dq = torch.empty((bsz, k, emb), dtype=torch.float32, device=h.device)
    cuda_lib.launch("maskhead_bwd", h.device, h, wt, b, q, masks, dout, dacc,
                    part, dq, bsz, t, h2, freq_bins, emb, k)
    return dacc, dq
