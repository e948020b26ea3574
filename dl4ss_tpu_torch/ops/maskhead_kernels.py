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
tile layout once per version of W and the packed copy is kept while W
lives; a training step's backward takes the pack its forward used.

Both kernels run one wgmma main loop (csrc/maskhead_tile.cuh) whose order
of work cannot run off the card, so `pack_w_mirror`,
`fused_dot_masks_tile_mirror` and `fused_dot_masks_bwd_tile_mirror` repeat
it in plain torch for the CPU tests and the card checks: the packed,
swizzled W; 64-row units of one utterance against column tiles of whole
E-groups; the E-contraction as a product with the 0/1 block-sum matrix S;
dq and db as per-unit partials summed in a fixed order. No serving or
training path calls the mirrors.
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
# the column sums behind dq are rounded to bf16; K6's units are the same 64
# rows of one utterance
_DQ_TILE = 64
# the kernels' tiling (csrc/maskhead_tile.cuh): columns of a tile, inner
# rows of a stage (one 128-byte swizzle atom of bf16), E-groups of a tile,
# queries per utterance
TILE_COLS = 256
TILE_INNER = 64
MAX_GROUPS = 16
MAX_QUERIES = 4


class _FusedDotMasks(torch.autograd.Function):
    """fused_dot_masks with its VJP: saves (hidden, w, b, queries, masks)
    as `_fwd_vjp` does. K6 (or its plain version) gives dacc, dq and db;
    dW and dh are the plain matrix products JAX also runs outside its
    kernel (pallas_maskhead.py:276-285)."""

    @staticmethod
    def forward(ctx, hidden, w, b, queries, freq_bins, emb):
        args = (hidden.to(torch.bfloat16).contiguous(), w.contiguous(),
                b.float().contiguous(), queries.to(torch.bfloat16).contiguous(),
                freq_bins, emb)
        ctx.wt = None
        if hidden.is_cuda:
            ctx.wt = _packed(args[1], freq_bins, emb)
            masks = fused_dot_masks_cuda(*args, hidden.dtype, wt=ctx.wt)
        else:
            masks = fused_dot_masks_plain(*args, hidden.dtype)
        ctx.save_for_backward(hidden, w, b, queries, masks)
        ctx.dims = (freq_bins, emb)
        return masks

    @staticmethod
    def backward(ctx, dout):
        hidden, w, b, queries, masks = ctx.saved_tensors
        freq_bins, emb = ctx.dims
        h16 = hidden.to(torch.bfloat16).contiguous()
        args = (h16, w.contiguous(), b.float().contiguous(),
                queries.to(torch.bfloat16).contiguous(),
                masks.to(torch.bfloat16).contiguous(),
                dout.to(torch.bfloat16).contiguous(), freq_bins, emb)
        if hidden.is_cuda:
            dacc, dq, db = fused_dot_masks_bwd_cuda(*args, wt=ctx.wt)
        else:
            dacc, dq, db = fused_dot_masks_bwd_plain(*args)
        dh, dw = dacc_products(h16, w, dacc)
        return (dh.to(hidden.dtype), dw.to(w.dtype), db.to(b.dtype),
                dq.to(queries.dtype), None, None)


def dacc_products(h16, w, dacc) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dh, dW) = (dacc.W^T, h^T.dacc) over the one bf16 dacc, as JAX
    computes them (pallas_maskhead.py:280-284): bf16 operands, f32
    accumulation and f32 output. On the card that is cuBLAS through
    `torch.mm(..., out_dtype=torch.float32)` (aten::mm.dtype, which PyTorch
    registers for CUDA only; a torch without it raises here). On the CPU,
    `dacc_products_plain`: the same values up to summation order, since a
    product of two bf16 values is exact in f32."""
    if not dacc.is_cuda:
        return dacc_products_plain(h16, w, dacc)
    d, fe = h16.shape[-1], dacc.shape[-1]
    rows = dacc.reshape(-1, fe)
    dw = torch.mm(h16.reshape(-1, d).T, rows, out_dtype=torch.float32)
    dh = torch.mm(rows, w.to(torch.bfloat16).T, out_dtype=torch.float32)
    return dh.reshape(*dacc.shape[:-1], d), dw


def dacc_products_plain(h16, w, dacc) -> Tuple[torch.Tensor, torch.Tensor]:
    """`dacc_products` as f32 products of the upcast bf16 operands: the
    CPU route, and on the card the yardstick the bf16 products are held
    to."""
    d = h16.shape[-1]
    dacc32 = dacc.float()
    dw = torch.matmul(h16.float().reshape(-1, d).T,
                      dacc32.reshape(-1, dacc.shape[-1]))
    dh = torch.matmul(dacc32, w.to(torch.bfloat16).float().T)
    return dh, dw


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
    """W (D, F*E), f32 or bf16, on the card -> the kernels' packed bf16
    tiles, in one pass (csrc/maskhead_fwd.cu, `dl4ss_maskhead_pack`); the
    same elements as `pack_w_mirror`."""
    d = w.shape[0]
    cuda_lib.check(w, "w", _W_DTYPES, (d, freq_bins * emb))
    n = cuda_lib.query("maskhead_packed_size", d, freq_bins, emb)
    if n < 0:
        raise ValueError(f"fused_dot_masks: embedding width {emb} is outside "
                         f"the kernel's 1..{TILE_COLS}")
    wt = torch.empty((n,), dtype=torch.bfloat16, device=w.device)
    cuda_lib.launch("maskhead_pack", w.device, w, wt, d, freq_bins, emb,
                    int(w.dtype == torch.float32))
    return wt


def _packed(w: torch.Tensor, freq_bins: int, emb: int) -> torch.Tensor:
    """`pack_w(w)`, built once per version of W (an in-place update of W
    repacks it). Inference tensors keep no version, and a CUDA graph
    replays its capture on every later version of W: both pack every call
    and leave the cache alone (a capture only records the pack, which runs
    at each replay)."""
    if w.is_inference() or torch.cuda.is_current_stream_capturing():
        return pack_w(w, freq_bins, emb)
    key = (w._version, w.data_ptr(), freq_bins, emb)
    hit = _PACKED.get(w)
    if hit is None or hit[0] != key:
        hit = _PACKED[w] = (key, pack_w(w, freq_bins, emb))
    return hit[1]


def _kernel_rows(h: torch.Tensor) -> torch.Tensor:
    """h (B, T, D) bf16 as the kernels' tensor map reads it: 16-byte
    aligned rows, so D a multiple of 8. h is read in place when it is (D =
    600 on every preset); otherwise a copy with zero columns up to the next
    multiple of 8 (W's packed tiles are zero there too)."""
    d = h.shape[-1]
    if d % 8:
        return torch.nn.functional.pad(h, (0, -d % 8))
    return h if h.data_ptr() % 16 == 0 else h.clone()


def _check_common(h, w, b, q, freq_bins, emb):
    bsz, _, h2 = h.shape
    k = q.shape[1]
    fe = freq_bins * emb
    cuda_lib.check(h, "hidden", (torch.bfloat16,))
    cuda_lib.check(w, "w", _W_DTYPES, (h2, fe))
    cuda_lib.check(b, "b", (torch.float32,), (fe,))
    cuda_lib.check(q, "queries", (torch.bfloat16,), (bsz, k, emb))
    if not 1 <= k <= MAX_QUERIES:
        raise ValueError(f"fused_dot_masks: the kernels take 1..{MAX_QUERIES} "
                         f"queries per utterance, got {k}")


def fused_dot_masks_cuda(h, w, b, q, freq_bins: int, emb: int, out_dtype,
                         wt=None) -> torch.Tensor:
    """K3 on the card: csrc/maskhead_fwd.cu, on h (B, T, D) in its own
    layout (`_kernel_rows`) and W packed once per version (`_packed`), or
    the pack `wt` of this W."""
    _check_common(h, w, b, q, freq_bins, emb)
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {_OUT_DTYPES}")
    bsz, t, _ = h.shape
    k = q.shape[1]
    wt = _packed(w, freq_bins, emb) if wt is None else wt
    hk = _kernel_rows(h)
    out = torch.empty((bsz, k, t, freq_bins), dtype=out_dtype,
                      device=h.device)
    cuda_lib.launch("maskhead_fwd", h.device, hk, wt, b, q, out, bsz, t,
                    hk.shape[-1], freq_bins, emb, k,
                    int(out_dtype == torch.bfloat16))
    return out


def fused_dot_masks_bwd_plain(h, w, b, q, masks, dout, freq_bins: int,
                              emb: int) -> Tuple[torch.Tensor, ...]:
    """K6's plain version: `_bwd_kernel`'s math on bf16 h, q, masks and
    dout (W is rounded to bf16 here) -> dacc (B, T, F*E) bf16, dq (B, K, E)
    f32 and db (F*E,) f32, the column sums behind dq rounded to bf16 per
    64-row time tile as in the kernels, db the f32 sum of dacc."""
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
    return dacc, dq, dacc.float().sum(dim=(0, 1))


def fused_dot_masks_bwd_cuda(h, w, b, q, masks, dout, freq_bins: int,
                             emb: int, wt=None) -> Tuple[torch.Tensor, ...]:
    """K6 on the card: csrc/maskhead_bwd.cu on h (B, T, D) in its own
    layout and the W that K3 packed for this version (`_packed`), or the
    pack `wt` of this W. Same contract as `fused_dot_masks_bwd_plain`; db
    comes from the kernel's per-unit partials."""
    _check_common(h, w, b, q, freq_bins, emb)
    bsz, t, _ = h.shape
    k = q.shape[1]
    fe = freq_bins * emb
    cuda_lib.check(masks, "masks", (torch.bfloat16,), (bsz, k, t, freq_bins))
    cuda_lib.check(dout, "dout", (torch.bfloat16,), (bsz, k, t, freq_bins))
    wt = _packed(w, freq_bins, emb) if wt is None else wt
    hk = _kernel_rows(h)
    n = cuda_lib.query("maskhead_bwd_partials", bsz, t, hk.shape[-1],
                       freq_bins, emb, k)
    dacc = torch.empty((bsz, t, fe), dtype=torch.bfloat16, device=h.device)
    part = torch.empty((n,), dtype=torch.float32, device=h.device)
    dq = torch.empty((bsz, k, emb), dtype=torch.float32, device=h.device)
    db = torch.empty((fe,), dtype=torch.float32, device=h.device)
    cuda_lib.launch("maskhead_bwd", h.device, hk, wt, b, q, masks, dout, dacc,
                    part, dq, db, bsz, t, hk.shape[-1], freq_bins, emb, k)
    return dacc, dq, db


# ---- the kernels' order of work in plain torch (tests and card checks) ----

def tile_geometry(d: int, freq_bins: int, emb: int) -> Tuple[int, int, int]:
    """(E-groups a tile, tiles, stages of TILE_INNER inner rows) of the
    packed W for W (d, F*E): `mh_geometry` of csrc/maskhead_tile.cuh."""
    if d < 1 or freq_bins < 1 or not 1 <= emb <= TILE_COLS:
        raise ValueError(f"no tiling for d={d}, F={freq_bins}, E={emb}")
    ft = min(freq_bins, TILE_COLS // emb, MAX_GROUPS)
    return ft, -(-freq_bins // ft), -(-d // TILE_INNER)


def _swizzle(device) -> torch.Tensor:
    """(TILE_COLS, TILE_INNER) index: element [n, p] of a packed slice holds
    inner element idx[n, p] of row n (the 128-byte swizzle moves 16-byte
    chunk c of row n to chunk c ^ (n % 8); the map is its own inverse)."""
    n = torch.arange(TILE_COLS, device=device)[:, None]
    p = torch.arange(TILE_INNER, device=device)[None, :]
    return (((p >> 3) ^ n) & 7) << 3 | (p & 7)


def pack_w_mirror(w: torch.Tensor, freq_bins: int, emb: int) -> torch.Tensor:
    """The packed W that `pack_w` writes, in plain torch: (ntiles, nslices,
    TILE_COLS, TILE_INNER) bf16 flattened, slab (j, s) row n holding
    W[s*64 : s*64+64, j*ft*E + n] swizzled, zero past D and past the tile's
    ft*E columns."""
    d, fe = w.shape
    ft, ntiles, nslices = tile_geometry(d, freq_bins, emb)
    nc = ft * emb
    wp = torch.zeros((nslices * TILE_INNER, ntiles * nc), dtype=torch.bfloat16,
                     device=w.device)
    wp[:d, :fe] = w.to(torch.bfloat16)
    tiles = wp.reshape(nslices, TILE_INNER, ntiles, nc).permute(2, 0, 3, 1)
    logical = torch.nn.functional.pad(tiles, (0, 0, 0, TILE_COLS - nc))
    idx = _swizzle(w.device).expand(ntiles, nslices, -1, -1)
    return logical.gather(-1, idx).reshape(-1)


def _unpack(wt: torch.Tensor, d: int, freq_bins: int, emb: int
            ) -> torch.Tensor:
    """Packed W -> (ntiles, nslices * TILE_INNER, TILE_COLS) f32: each
    tile's inner rows by its columns, as the tensor cores read it."""
    _, ntiles, nslices = tile_geometry(d, freq_bins, emb)
    slabs = wt.reshape(ntiles, nslices, TILE_COLS, TILE_INNER)
    idx = _swizzle(wt.device).expand(ntiles, nslices, -1, -1)
    logical = slabs.gather(-1, idx)
    return logical.permute(0, 1, 3, 2).reshape(ntiles, -1, TILE_COLS).float()


def _units(h: torch.Tensor, rows: int) -> torch.Tensor:
    """h (B, T, D) -> (B * nt, 64, rows) f32: the 64-row units of each
    utterance, zero past T and past D."""
    bsz, t, d = h.shape
    nt = -(-t // _DQ_TILE)
    hp = torch.nn.functional.pad(h.float(), (0, rows - d, 0, nt * _DQ_TILE - t))
    return hp.reshape(bsz * nt, _DQ_TILE, rows)


def _tile_g(units, wl, b, j, ft, freq_bins, emb):
    """g = tanh(acc + bias) of column tile j for every unit (U, 64,
    TILE_COLS), zero bias past the tile's columns; and (f0, fn, c0, nc)."""
    f0 = j * ft
    fn = min(ft, freq_bins - f0)
    c0, nc = f0 * emb, fn * emb
    bias = torch.zeros(TILE_COLS, dtype=torch.float32, device=units.device)
    bias[:nc] = b[c0:c0 + nc].float()
    return torch.tanh(units @ wl[j] + bias), (f0, fn, c0, nc)


def _qrep(q: torch.Tensor, nt: int, nc: int, emb: int) -> torch.Tensor:
    """q (B, K, E) -> (B * nt, K, TILE_COLS): q_k[c % E] per column c < nc
    of a tile, per unit, zero past nc."""
    reps = -(-nc // emb)
    qr = q.float().repeat(1, 1, reps)[..., :nc]
    qr = torch.nn.functional.pad(qr, (0, TILE_COLS - nc))
    return qr.repeat_interleave(nt, dim=0)


def _group_of_column(emb: int, device) -> torch.Tensor:
    return (torch.arange(TILE_COLS, device=device) // emb).clamp(
        max=MAX_GROUPS - 1)


def fused_dot_masks_tile_mirror(h, wt, b, q, freq_bins: int, emb: int,
                                out_dtype) -> torch.Tensor:
    """K3's order of work in plain torch on bf16 h and q and the packed W
    `wt`: per 64-row unit and column tile, g = tanh(h . W_tile + b); per
    query k the product bf16(g * q_k) contracted over E with the 0/1
    block-sum matrix S (TILE_COLS x MAX_GROUPS) in f32, then the sigmoid."""
    bsz, t, d = h.shape
    k = q.shape[1]
    ft, ntiles, nslices = tile_geometry(d, freq_bins, emb)
    nt = -(-t // _DQ_TILE)
    wl = _unpack(wt, d, freq_bins, emb)
    units = _units(h, nslices * TILE_INNER)
    cols = torch.arange(TILE_COLS, device=h.device)
    s = ((cols[:, None] // emb == torch.arange(MAX_GROUPS, device=h.device))
         & (cols[:, None] < ft * emb)).float()
    out = torch.zeros((bsz * nt, k, _DQ_TILE, freq_bins), device=h.device)
    for j in range(ntiles):
        g, (f0, fn, _, nc) = _tile_g(units, wl, b, j, ft, freq_bins, emb)
        gq = (g[:, None] * _qrep(q, nt, nc, emb)[:, :, None, :]).to(
            torch.bfloat16).float()
        out[..., f0:f0 + fn] = torch.sigmoid(gq @ s)[..., :fn]
    out = out.reshape(bsz, nt, k, _DQ_TILE, freq_bins).transpose(1, 2)
    return out.reshape(bsz, k, nt * _DQ_TILE, freq_bins)[:, :, :t].to(
        out_dtype)


def fused_dot_masks_bwd_tile_mirror(h, wt, b, q, masks, dout, freq_bins: int,
                                    emb: int) -> Tuple[torch.Tensor, ...]:
    """K6's order of work in plain torch: per 64-row unit and column tile,
    g recomputed as in `fused_dot_masks_tile_mirror`; the unit's dq
    partial (its column sums of g * de_k, rounded to bf16, folded over the
    tile's groups) and db partial (its column sums of the bf16 dacc in
    f32); then the fixed-order sums (dq: time tile, then column tile; db:
    unit by unit). Returns (dacc, dq, db) as `fused_dot_masks_bwd_plain`."""
    bsz, t, d = h.shape
    k = q.shape[1]
    fe = freq_bins * emb
    ft, ntiles, nslices = tile_geometry(d, freq_bins, emb)
    nt = -(-t // _DQ_TILE)
    nunits = bsz * nt
    wl = _unpack(wt, d, freq_bins, emb)
    units = _units(h, nslices * TILE_INNER)
    m = masks.float()
    de = (dout.float() * m * (1.0 - m)).to(torch.bfloat16).float()
    de = torch.nn.functional.pad(de, (0, 0, 0, nt * _DQ_TILE - t)).reshape(
        bsz, k, nt, _DQ_TILE, freq_bins).transpose(1, 2).reshape(
        nunits, k, _DQ_TILE, freq_bins)
    group = _group_of_column(emb, h.device)
    dacc = torch.zeros((nunits, _DQ_TILE, fe), dtype=torch.bfloat16,
                       device=h.device)
    dq_part = torch.zeros((nunits, ntiles, k, emb), device=h.device)
    db_part = torch.zeros((nunits, fe), device=h.device)
    for j in range(ntiles):
        g, (f0, fn, c0, nc) = _tile_g(units, wl, b, j, ft, freq_bins, emb)
        de_t = torch.zeros((nunits, k, _DQ_TILE, MAX_GROUPS), device=h.device)
        de_t[..., :fn] = de[..., f0:f0 + fn]
        de_c = de_t[..., group]                    # (U, K, 64, TILE_COLS)
        col = (g[:, None] * de_c).sum(2).to(torch.bfloat16).float()
        dq_part[:, j] = col[..., :nc].reshape(nunits, k, fn, emb).sum(2)
        qr = _qrep(q, nt, nc, emb)
        dg = torch.zeros_like(g)
        for ki in range(k):
            dg = dg + de_c[:, ki] * qr[:, ki, None, :]
        a = (dg * (1.0 - g * g)).to(torch.bfloat16)
        dacc[..., c0:c0 + nc] = a[..., :nc]
        db_part[:, c0:c0 + nc] = a[..., :nc].float().sum(1)
    dq = dq_part.reshape(bsz, nt * ntiles, k, emb).sum(1)
    db = db_part.sum(0)
    return dacc.reshape(bsz, nt * _DQ_TILE, fe)[:, :t], dq, db
