"""The recurrent kernels: K2 and K5 (the BiGRU forward recurrence and its
backward), K7 and K8 (the BiLSTM's). CUDA kernels and plain versions.

Ports `pallas_gru_scan` and `pallas_lstm_scan` (dl4ss_tpu/ops/pallas_rnn.py)
with their custom VJPs. `gru_scan` and `lstm_scan` are
`torch.autograd.Function`s: the forward sends a CPU tensor to the plain
PyTorch loop and a CUDA tensor to the hand-written kernel (csrc/gru_fwd.cu,
csrc/lstm_fwd.cu), the backward likewise to the plain reverse loop or to
csrc/gru_bwd.cu, csrc/lstm_bwd.cu; there is no fallback between them.
Unlike the TPU kernels, the hidden width needs no 128-lane padding. The
direction count D is the operands' second axis: 2 for a bidirectional
layer, 1 for a one-direction one (`rnn_init(..., bidirectional=False)`).
The kernels take either: each direction is a barrier group of its own,
and the time order is the caller's (the reverse direction is flipped
outside), so D only sizes the grid, the tickets and the rows a resident
launch holds.

All four kernels have two bodies each, and K7 a third. The resident one
walks the whole chain of T steps in ONE persistent cooperative launch (per
chunk of batch rows) with each block's slice of U in registers: the
forward's (csrc/rnn_fwd_common.cuh) holds the gate columns of its units,
the backward's (csrc/rnn_bwd_common.cuh) their rows, after the gate
recompute for all steps at once and before a split dU reduction. The
stepwise one launches a kernel per step. K7's wide body
(csrc/rnn_fwd_wide.cuh) is one persistent launch for the widths past the
registers, with each direction's U held once in the blocks' shared memory
for all batch rows. `rnn_body` is the only rule that picks between them,
from the shape alone, for both passes; the launch names the body to the
library, which refuses the resident and wide bodies where they cannot
run. The backward's resident arithmetic, which runs only on the card, has
plain-torch mirrors here (`gru_bwd_resident_mirror`,
`lstm_bwd_resident_mirror`) for the CPU tests; the forward's is the plain
loop's, summed in another order.
"""

from __future__ import annotations

import collections
from typing import Optional, Tuple

import torch

from dl4ss_tpu_torch.ops import cuda_lib

_DTYPES = (torch.float32, torch.bfloat16)

# The two bodies of K2, K5, K7 and K8 and what the resident one can hold: a
# block keeps the weights of RESIDENT_UNITS hidden units in registers (the
# LSTM's 4H columns a unit up to H = RESIDENT_MAX_HIDDEN), the blocks of one
# direction and RESIDENT_ROWS batch rows share a barrier, and every block of
# a launch must be on an SM at once: one block per SM of the card (H100_SMS
# on an H100 SXM, the default where no device is named). A batch whose grid
# does not fit runs in chunks of rows, one launch each. RESIDENT_MAX_HIDDEN
# and RESIDENT_UNITS only steer the rule: if they drift from
# csrc/rnn_resident.cuh the launch is refused, nothing is overrun.
# RESIDENT_ROWS and DU_SPLIT size scratch, so the launch passes the sizes it
# allocated and the library refuses any but its own.
BODY_RESIDENT, BODY_STEPWISE, BODY_WIDE = "resident", "stepwise", "wide"
_BODY_CODES = {BODY_RESIDENT: 1, BODY_STEPWISE: 2, BODY_WIDE: 3}
RESIDENT_MAX_HIDDEN = 304
RESIDENT_UNITS = 24
RESIDENT_ROWS = 4
H100_SMS = 132
# The most launches (chunks of rows) per call at which the resident body is
# named, by pass; past it the stepwise body was as fast or faster on an
# NVIDIA H100 80GB HBM3 at H=300 (PERF.md, PR 6): a forward chunk costs
# ~1.1 ms (GRU) / ~1.3 (LSTM), the stepwise forward 3.1-3.9 ms up to B=96 and
# 7-8 at B=128, so the forward's resident body won at 2 chunks (B=32) and
# lost from 3 (LSTM) or 4 (GRU) on; the backward's won at 2 and at 7 (B=128,
# 12-14 ms against 22-24), the most measured.
RESIDENT_MAX_CHUNKS = {"forward": 2, "backward": 7}
DU_SPLIT = 16       # slices of the (t, b) axis in the dU reduction
# K7's wide body (csrc/rnn_fwd_wide.cuh) for H > RESIDENT_MAX_HIDDEN: a
# block holds the 4 gate columns of WIDE_UNITS hidden units of one direction
# for every batch row, in shared memory, so D * ceil(H / WIDE_UNITS) blocks
# must fit the card's SMs at once and `wide_smem_bytes` a block's limit,
# SMEM_PER_BLOCK. Like RESIDENT_UNITS these only steer the rule: the library
# computes its own and refuses what does not fit. WIDE_MAX_BATCH is the
# most rows at which the wide body was measured to beat the stepwise one.
WIDE_UNITS = 10
WIDE_TILE_ROWS = 4
WIDE_THREADS = 256
SMEM_PER_BLOCK = 232448
WIDE_MAX_BATCH = 48
# Launches of K2, K5, K7 and K8 by the body that ran, keyed (kernel name,
# body); cuda_lib.LAUNCHES counts both bodies under the kernel's name.
BODY_LAUNCHES: collections.Counter = collections.Counter()
cuda_lib.COUNTERS.append(BODY_LAUNCHES)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def resident_groups(batch: int, directions: int = 2) -> int:
    """Barrier groups of the resident body: one per direction and tile of
    RESIDENT_ROWS batch rows."""
    return directions * _ceil_div(batch, RESIDENT_ROWS)


def resident_chunk_rows(hidden: int, directions: int = 2,
                        sms: int = H100_SMS) -> int:
    """Batch rows per launch of the resident body: the most tiles of
    RESIDENT_ROWS rows whose blocks, ceil(H / RESIDENT_UNITS) per direction
    and tile, fit `sms` SMs at once (20 rows at H=300 on 132 SMs); 0 where
    not one tile fits."""
    per_tile = directions * _ceil_div(hidden, RESIDENT_UNITS)
    return RESIDENT_ROWS * (sms // per_tile)


def resident_chunks(batch: int, hidden: int, directions: int = 2,
                    sms: int = H100_SMS):
    """The resident body's launches for a batch, as the library makes them
    (csrc/rnn_resident.cuh, `chunked`): (first row, rows) of each chunk, in
    order; none where not one tile fits."""
    step = resident_chunk_rows(hidden, directions, sms)
    if not step:
        return []
    return [(r, min(step, batch - r)) for r in range(0, batch, step)]


def wide_smem_bytes(hidden: int, batch: int) -> int:
    """Shared memory of a block of K7's wide body, as the library sizes it
    (csrc/rnn_fwd_wide.cuh, `smem_bytes`): the block's U, 4 * WIDE_UNITS
    f32 columns over H rows rounded up to 4, and the larger of the staged
    rows (B rounded up to WIDE_TILE_ROWS, each ceil(H / 4) float4 made odd)
    and the partial sums (2 * WIDE_TILE_ROWS float4 a thread)."""
    kq, tr = _ceil_div(hidden, 4), WIDE_TILE_ROWS
    return 16 * (4 * kq * WIDE_UNITS + max(
        tr * _ceil_div(batch, tr) * (kq | 1), 2 * tr * WIDE_THREADS))


def rnn_body(hidden: int, batch: int, directions: int = 2,
             sms: int = H100_SMS, backward: bool = False,
             gates: int = 4) -> str:
    """The shape rule of K2 and K7 (forward) and K5 and K8 (`backward`) on
    the card: the resident body where a block's slice of U fits its
    registers (H <= 304) and the batch takes at most the pass's
    RESIDENT_MAX_CHUNKS launches of the grid that fits the card's `sms` SMs
    at once (at H=300 on 132 SMs 20 rows a launch: the forward's resident
    body up to B=40, the backward's up to B=140). Past H=304, K7's forward
    (`gates` 4; K2 passes 3) takes the wide body where its D *
    ceil(H / WIDE_UNITS) blocks fit the `sms` SMs (H <= 660 for both
    directions on 132), a block fits SMEM_PER_BLOCK (at H=660 up to B=48)
    and B <= WIDE_MAX_BATCH. Every other shape, every backward
    past H=304 among them, takes the stepwise body. The dtype does not
    enter: U is held in f32 either way. The launch is told the body by
    name; the library only refuses the resident or wide body on a shape it
    cannot take."""
    if hidden <= RESIDENT_MAX_HIDDEN:
        chunks = resident_chunks(batch, hidden, directions, sms)
        most = RESIDENT_MAX_CHUNKS["backward" if backward else "forward"]
        return BODY_RESIDENT if 0 < len(chunks) <= most else BODY_STEPWISE
    if (not backward and gates == 4 and batch <= WIDE_MAX_BATCH
            and directions * _ceil_div(hidden, WIDE_UNITS) <= sms
            and wide_smem_bytes(hidden, batch) <= SMEM_PER_BLOCK):
        return BODY_WIDE
    return BODY_STEPWISE


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _resident_scratch(dev, hidden: int, batch: int, directions: int):
    """The resident body's tickets (zeroed, one per group), their count and
    the rows per launch, on the card `dev`."""
    groups = resident_groups(batch, directions)
    return (torch.zeros(groups, dtype=torch.int32, device=dev), groups,
            resident_chunk_rows(hidden, directions, _sms(dev)))


class _GruScan(torch.autograd.Function):
    """pallas_gru_scan with its VJP: saves (xp, wh, bh_n, hs) as
    `_gru_fwd_vjp` does and rebuilds h_prev in the backward."""

    @staticmethod
    def forward(ctx, xp, wh, bh_n):
        hs = gru_scan_cuda(xp, wh, bh_n) if xp.is_cuda else \
            gru_scan_plain(xp, wh, bh_n)
        ctx.save_for_backward(xp, wh, bh_n, hs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        xp, wh, bh_n, hs = ctx.saved_tensors
        hprev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        bwd = gru_scan_bwd_cuda if xp.is_cuda else gru_scan_bwd_plain
        return bwd(xp, wh, bh_n, hprev, dhs.contiguous())


def gru_scan(xp: torch.Tensor, wh: torch.Tensor, bh_n: torch.Tensor
             ) -> torch.Tensor:
    """xp (T, D, B, 3H) input projections (+ r,z biases folded in), wh
    (D, H, 3H) recurrent weights in xp's dtype, bh_n (D, 1, H) f32
    candidate bias -> hs (T, D, B, H) in xp's dtype, with h0 = 0.

    f32 inputs compute in f32; bf16 inputs keep bf16 operands and carry
    with f32 accumulation, as the JAX kernel does. Differentiable: the
    backward is K5 on the card."""
    return _GruScan.apply(xp, wh, bh_n)


def gru_scan_plain(xp: torch.Tensor, wh: torch.Tensor, bh_n: torch.Tensor
                   ) -> torch.Tensor:
    """K2's plain version: the same gate math as a loop over time."""
    t, d, b, g3 = xp.shape
    hidden = g3 // 3
    w = wh.float()
    h = torch.zeros((d, b, hidden), dtype=xp.dtype, device=xp.device)
    hs = torch.empty((t, d, b, hidden), dtype=xp.dtype, device=xp.device)
    for s in range(t):
        a = torch.bmm(h.float(), w)                       # (D, B, 3H)
        x = xp[s].float()
        rz = torch.sigmoid(x[..., :2 * hidden] + a[..., :2 * hidden])
        r, z = rz[..., :hidden], rz[..., hidden:]
        n = torch.tanh(x[..., 2 * hidden:] + r * (a[..., 2 * hidden:] + bh_n))
        h = ((1.0 - z) * n + z * h.float()).to(xp.dtype)
        hs[s] = h
    return hs


def gru_scan_cuda(xp: torch.Tensor, wh: torch.Tensor, bh_n: torch.Tensor,
                  body: Optional[str] = None) -> torch.Tensor:
    """K2 on the card: csrc/gru_fwd.cu, one ctypes call per layer on the
    current stream. The resident body makes one persistent launch for all
    steps (per chunk of rows); the stepwise body one launch per step.
    `body` forces one of the two for a check or a timing; by default
    `rnn_body` names it from the shape. Same contract as `gru_scan_plain`."""
    t, d, b, g3 = xp.shape
    if g3 % 3:
        raise ValueError(f"xp's last axis must be 3H, got {g3}")
    hidden = g3 // 3
    cuda_lib.check(xp, "xp", _DTYPES)
    cuda_lib.check(wh, "wh", (xp.dtype,), (d, hidden, g3))
    cuda_lib.check(bh_n, "bh_n", (torch.float32,), (d, 1, hidden))
    dev = xp.device
    chosen = body or rnn_body(hidden, b, d, _sms(dev), gates=3)
    hs = torch.empty((t, d, b, hidden), dtype=xp.dtype, device=dev)
    tickets = groups = chunk = 0
    if chosen != BODY_STEPWISE:
        tickets, groups, chunk = _resident_scratch(dev, hidden, b, d)
    cuda_lib.launch("gru_fwd", dev, xp, wh, bh_n, hs, tickets, groups, chunk,
                    t, d, b, hidden, int(xp.dtype == torch.bfloat16),
                    _BODY_CODES[chosen])
    BODY_LAUNCHES["gru_fwd", chosen] += 1
    return hs


def gru_scan_bwd_plain(xp, wh, bh_n, hprev, dhs
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's plain version: `_gru_bwd_kernel`'s math as a loop run in
    reverse. hprev (T, D, B, H) is hs one step late (zero at t = 0); dhs
    (T, D, B, H) in xp's dtype. Returns dxp (T, D, B, 3H) in xp's dtype, dU
    (D, H, 3H) accumulated in f32 and cast to wh's dtype, and db_n
    (D, 1, H). In bf16, da_w is rounded to bf16 before both products."""
    t, d, b, g3 = xp.shape
    hidden = g3 // 3
    w = wh.float()
    dxp = torch.empty_like(xp)
    du = torch.zeros((d, hidden, g3), dtype=torch.float32, device=xp.device)
    dbn = torch.zeros((d, 1, hidden), dtype=torch.float32, device=xp.device)
    carry = torch.zeros((d, b, hidden), dtype=torch.float32, device=xp.device)
    for s in reversed(range(t)):
        hp = hprev[s].float()
        a = torch.bmm(hp, w)                              # gate recompute
        x = xp[s].float()
        rz = torch.sigmoid(x[..., :2 * hidden] + a[..., :2 * hidden])
        r, z = rz[..., :hidden], rz[..., hidden:]
        hn = a[..., 2 * hidden:] + bh_n
        n = torch.tanh(x[..., 2 * hidden:] + r * hn)
        dh = carry + dhs[s].float()
        dn = dh * (1.0 - z)
        dz = dh * (hp - n)
        da_n = dn * (1.0 - n * n)
        dr = da_n * hn
        dhn = da_n * r
        da_z = dz * z * (1.0 - z)
        da_r = dr * r * (1.0 - r)
        # xp sees (da_r, da_z, da_n); the recurrent product (da_r, da_z, dhn)
        dxp[s] = torch.cat([da_r, da_z, da_n], dim=-1).to(xp.dtype)
        da_w = torch.cat([da_r, da_z, dhn], dim=-1).to(dhs.dtype).float()
        carry = dh * z + torch.bmm(da_w, w.transpose(1, 2))
        du += torch.bmm(hp.transpose(1, 2), da_w)
        dbn += dhn.sum(dim=1, keepdim=True)
    return dxp, du.to(wh.dtype), dbn.to(bh_n.dtype)


def _du_partials(d: int, hidden: int, gates: int, dev) -> torch.Tensor:
    return torch.empty((DU_SPLIT, d, hidden, gates), dtype=torch.float32,
                       device=dev)


def _sum_du_partials(hp: torch.Tensor, da: torch.Tensor) -> torch.Tensor:
    """dU as the kernels' phase C takes it: the (t, b) axis cut into
    DU_SPLIT slices, each slice's hprev^T . da, the partials added in
    order. hp (T, D, B, H) and da (T, D, B, G) in f32 -> (D, H, G)."""
    t, d, b, _ = hp.shape
    rows_h = hp.transpose(0, 1).reshape(d, t * b, -1)
    rows_a = da.transpose(0, 1).reshape(d, t * b, -1)
    chunk = _ceil_div(t * b, DU_SPLIT)
    du = torch.zeros((d, hp.shape[-1], da.shape[-1]), dtype=torch.float32,
                     device=hp.device)
    for lo in range(0, t * b, chunk):
        du += torch.bmm(rows_h[:, lo:lo + chunk].transpose(1, 2),
                        rows_a[:, lo:lo + chunk])
    return du


def gru_bwd_resident_mirror(xp, wh, bh_n, hprev, dhs
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The resident body of K5 step for step in plain torch, for the CPU
    tests: phase A (the gates of every step from one product, turned into
    the five coefficients c_r, c_z, c_n, c_h, z), phase B (the chain, linear
    in dh), phase C (dU from DU_SPLIT partial sums; db_n summed over t per
    row, then over the rows). Same contract as `gru_scan_bwd_plain`."""
    t, d, b, g3 = xp.shape
    hidden = g3 // 3
    w, hp, x = wh.float(), hprev.float(), xp.float()
    a = torch.einsum("tdbk,dkg->tdbg", hp, w)
    r = torch.sigmoid(x[..., :hidden] + a[..., :hidden])
    z = torch.sigmoid(x[..., hidden:2 * hidden] + a[..., hidden:2 * hidden])
    hn = a[..., 2 * hidden:] + bh_n
    n = torch.tanh(x[..., 2 * hidden:] + r * hn)
    c_n = (1.0 - z) * (1.0 - n * n)
    c_r = c_n * hn * r * (1.0 - r)
    c_z = (hp - n) * z * (1.0 - z)
    c_h = c_n * r
    dxp = torch.empty_like(xp)
    daw = torch.empty_like(xp)
    dhz = torch.zeros((d, b, hidden), dtype=torch.float32, device=xp.device)
    dot = torch.zeros_like(dhz)
    dbn_rows = torch.zeros_like(dhz)
    for s in reversed(range(t)):
        dh = dhz + dot + dhs[s].float()
        da_r, da_z, dhn = dh * c_r[s], dh * c_z[s], dh * c_h[s]
        dxp[s] = torch.cat([da_r, da_z, dh * c_n[s]], dim=-1).to(xp.dtype)
        daw[s] = torch.cat([da_r, da_z, dhn], dim=-1).to(xp.dtype)
        dot = torch.bmm(daw[s].float(), w.transpose(1, 2))
        dhz = dh * z[s]
        dbn_rows += dhn
    du = _sum_du_partials(hp, daw.float())
    return dxp, du.to(wh.dtype), dbn_rows.sum(dim=1, keepdim=True)


def gru_scan_bwd_cuda(xp, wh, bh_n, hprev, dhs, body: Optional[str] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5 on the card: csrc/gru_bwd.cu, one ctypes call per layer. The
    resident body launches the coefficient product, one persistent chain
    kernel for all steps and the dU / db_n reductions; the stepwise body
    transposes U, launches one step kernel per time step in reverse, then
    reduces. `body` forces one of the two for a check or a timing; by
    default `rnn_body` names it from the shape. Same contract as
    `gru_scan_bwd_plain`. Scratch is allocated per call and freed after:
    at T=313, B=16, H=300 in f32 the resident body's peak is 60 MB of
    coefficients, 36 MB of da_w and 35 MB of dU partials."""
    t, d, b, g3 = xp.shape
    if g3 % 3:
        raise ValueError(f"xp's last axis must be 3H, got {g3}")
    hidden = g3 // 3
    cuda_lib.check(xp, "xp", _DTYPES)
    cuda_lib.check(wh, "wh", (xp.dtype,), (d, hidden, g3))
    cuda_lib.check(bh_n, "bh_n", (torch.float32,), (d, 1, hidden))
    cuda_lib.check(hprev, "hprev", (xp.dtype,), (t, d, b, hidden))
    cuda_lib.check(dhs, "dhs", (xp.dtype,), (t, d, b, hidden))
    dev = xp.device
    chosen = body or rnn_body(hidden, b, d, _sms(dev), backward=True)
    f32 = dict(dtype=torch.float32, device=dev)
    dxp = torch.empty_like(xp)
    du = torch.empty((d, hidden, g3), **f32)
    dbn = torch.empty((d, 1, hidden), **f32)
    daw = torch.empty_like(xp)
    du_part = _du_partials(d, hidden, g3, dev)
    wht = dhz = tickets = groups = chunk = 0
    if chosen != BODY_STEPWISE:
        # the coefficients (T, D, B, H, 5), then the db_n partials (B, D, H)
        work = torch.empty(d * b * hidden * (5 * t + 1), **f32)
        tickets, groups, chunk = _resident_scratch(dev, hidden, b, d)
    else:
        wht = torch.empty((d, g3, hidden), dtype=xp.dtype, device=dev)
        dhz = torch.empty((d, b, hidden), **f32)
        work = torch.empty((t, d, b, hidden), **f32)      # dhn
    cuda_lib.launch("gru_bwd", dev, xp, wh, bh_n, hprev, dhs, dxp, du, dbn,
                    wht, daw, dhz, work, du_part, tickets, du_part.shape[0],
                    groups, chunk, t, d, b, hidden,
                    int(xp.dtype == torch.bfloat16), _BODY_CODES[chosen])
    BODY_LAUNCHES["gru_bwd", chosen] += 1
    return dxp, du.to(wh.dtype), dbn


# ---------------------------------------------------------------------------
# LSTM: K7 (forward) and K8 (backward)
# ---------------------------------------------------------------------------


class _LstmScan(torch.autograd.Function):
    """pallas_lstm_scan with its VJP: saves (xp, wh, hs, cs) as
    `_lstm_fwd_vjp` does and rebuilds h_prev and c_prev in the backward."""

    @staticmethod
    def forward(ctx, xp, wh):
        hs, cs = lstm_scan_cuda(xp, wh) if xp.is_cuda else \
            lstm_scan_plain(xp, wh)
        ctx.save_for_backward(xp, wh, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        xp, wh, hs, cs = ctx.saved_tensors
        zeros = torch.zeros_like(hs[:1])
        hprev = torch.cat([zeros, hs[:-1]])
        cprev = torch.cat([zeros, cs[:-1]])
        bwd = lstm_scan_bwd_cuda if xp.is_cuda else lstm_scan_bwd_plain
        return bwd(xp, wh, hprev, cprev, cs, dhs.contiguous())


def lstm_scan(xp: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """xp (T, D, B, 4H) input projections with bx + bh folded in (gate order
    i, f, g, o), wh (D, H, 4H) recurrent weights in xp's dtype -> hs
    (T, D, B, H) in xp's dtype, with h0 = c0 = 0.

    f32 inputs compute in f32; bf16 inputs keep bf16 operands and a bf16 h
    with f32 accumulation, and the cell state is carried in f32 either way,
    as the JAX kernel does. Differentiable: the backward is K8 on the
    card."""
    return _LstmScan.apply(xp, wh)


def _lstm_gates(a: torch.Tensor, hidden: int):
    """Pre-activations (..., 4H) -> the gates i, f, g, o."""
    i, f = torch.sigmoid(a[..., :2 * hidden]).split(hidden, dim=-1)
    g = torch.tanh(a[..., 2 * hidden:3 * hidden])
    return i, f, g, torch.sigmoid(a[..., 3 * hidden:])


def lstm_scan_plain(xp: torch.Tensor, wh: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's plain version: `_lstm_fwd_kernel`'s math as a loop over time.
    Returns (hs, cs), both (T, D, B, H) in xp's dtype; h is carried in xp's
    dtype and c in f32 (only the stored cs is rounded)."""
    t, d, b, g4 = xp.shape
    hidden = g4 // 4
    w = wh.float()
    h = torch.zeros((d, b, hidden), dtype=xp.dtype, device=xp.device)
    c = torch.zeros((d, b, hidden), dtype=torch.float32, device=xp.device)
    hs = torch.empty((t, d, b, hidden), dtype=xp.dtype, device=xp.device)
    cs = torch.empty_like(hs)
    for s in range(t):
        i, f, g, o = _lstm_gates(xp[s].float() + torch.bmm(h.float(), w),
                                 hidden)
        c = f * c + i * g
        h = (o * torch.tanh(c)).to(xp.dtype)
        hs[s] = h
        cs[s] = c.to(xp.dtype)
    return hs, cs


def _lstm_shape(xp: torch.Tensor):
    t, d, b, g4 = xp.shape
    if g4 % 4:
        raise ValueError(f"xp's last axis must be 4H, got {g4}")
    return t, d, b, g4 // 4


def lstm_scan_cuda(xp: torch.Tensor, wh: torch.Tensor,
                   body: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 on the card: csrc/lstm_fwd.cu, one ctypes call per layer, with
    the two bodies of `gru_scan_cuda` and the wide one, one launch with a
    ticket per direction (`body` forces one; by default `rnn_body` names it
    from the shape). Returns (hs, cs) as `lstm_scan_plain`."""
    t, d, b, hidden = _lstm_shape(xp)
    cuda_lib.check(xp, "xp", _DTYPES)
    cuda_lib.check(wh, "wh", (xp.dtype,), (d, hidden, 4 * hidden))
    dev = xp.device
    chosen = body or rnn_body(hidden, b, d, _sms(dev))
    hs = torch.empty((t, d, b, hidden), dtype=xp.dtype, device=dev)
    cs = torch.empty_like(hs)
    carry = tickets = groups = chunk = 0
    if chosen == BODY_WIDE:
        tickets, groups = torch.zeros(d, dtype=torch.int32, device=dev), d
    elif chosen != BODY_STEPWISE:
        tickets, groups, chunk = _resident_scratch(dev, hidden, b, d)
    else:
        carry = torch.empty((d, b, hidden), dtype=torch.float32, device=dev)
    cuda_lib.launch("lstm_fwd", dev, xp, wh, hs, cs, carry, tickets, groups,
                    chunk, t, d, b, hidden, int(xp.dtype == torch.bfloat16),
                    _BODY_CODES[chosen])
    BODY_LAUNCHES["lstm_fwd", chosen] += 1
    return hs, cs


def lstm_scan_bwd_plain(xp, wh, hprev, cprev, cs, dhs
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8's plain version: `_lstm_bwd_kernel`'s math as a loop run in
    reverse. hprev and cprev (T, D, B, H) are hs and cs one step late (zero
    at t = 0); cs and dhs (T, D, B, H) in xp's dtype. Returns dxp
    (T, D, B, 4H) in xp's dtype and dU (D, H, 4H) accumulated in f32 and
    cast to wh's dtype. da is rounded to dhs's dtype before both the carry
    product and the dU sum."""
    t, d, b, g4 = xp.shape
    hidden = g4 // 4
    w = wh.float()
    dxp = torch.empty_like(xp)
    du = torch.zeros((d, hidden, g4), dtype=torch.float32, device=xp.device)
    dh_carry = torch.zeros((d, b, hidden), dtype=torch.float32,
                           device=xp.device)
    dc_carry = torch.zeros_like(dh_carry)
    for s in reversed(range(t)):
        hp = hprev[s].float()
        i, f, g, o = _lstm_gates(xp[s].float() + torch.bmm(hp, w), hidden)
        tc = torch.tanh(cs[s].float())
        dh = dh_carry + dhs[s].float()
        do = dh * tc
        dc = dc_carry + dh * o * (1.0 - tc * tc)
        di, dg, df = dc * g, dc * i, dc * cprev[s].float()
        dc_carry = dc * f
        da = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                        dg * (1.0 - g * g), do * o * (1.0 - o)],
                       dim=-1).to(dhs.dtype)
        dxp[s] = da.to(xp.dtype)
        da = da.float()
        dh_carry = torch.bmm(da, w.transpose(1, 2))
        du += torch.bmm(hp.transpose(1, 2), da)
    return dxp, du.to(wh.dtype)


def lstm_bwd_resident_mirror(xp, wh, hprev, cprev, cs, dhs
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The resident body of K8 step for step in plain torch, for the CPU
    tests: phase A (the gates of every step from one product, turned into
    the six coefficients k_c, k_i, k_f, k_g, k_o, f), phase B (the chain,
    linear in dh and dc), phase C (dU from DU_SPLIT partial sums). Same
    contract as `lstm_scan_bwd_plain`."""
    t, d, b, g4 = xp.shape
    hidden = g4 // 4
    w, hp = wh.float(), hprev.float()
    i, f, g, o = _lstm_gates(
        xp.float() + torch.einsum("tdbk,dkg->tdbg", hp, w), hidden)
    tc = torch.tanh(cs.float())
    k_c = o * (1.0 - tc * tc)
    k_i = g * i * (1.0 - i)
    k_f = cprev.float() * f * (1.0 - f)
    k_g = i * (1.0 - g * g)
    k_o = tc * o * (1.0 - o)
    dxp = torch.empty_like(xp)
    dc_carry = torch.zeros((d, b, hidden), dtype=torch.float32,
                           device=xp.device)
    dot = torch.zeros_like(dc_carry)
    for s in reversed(range(t)):
        dh = dot + dhs[s].float()
        dc = dc_carry + dh * k_c[s]
        dxp[s] = torch.cat([dc * k_i[s], dc * k_f[s], dc * k_g[s],
                            dh * k_o[s]], dim=-1).to(xp.dtype)
        dot = torch.bmm(dxp[s].float(), w.transpose(1, 2))
        dc_carry = dc * f[s]
    return dxp, _sum_du_partials(hp, dxp.float()).to(wh.dtype)


def lstm_scan_bwd_cuda(xp, wh, hprev, cprev, cs, dhs,
                       body: Optional[str] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8 on the card: csrc/lstm_bwd.cu, one ctypes call per layer, with
    the two bodies of `gru_scan_bwd_cuda` (`body` forces one; by default
    `rnn_body` names it from the shape). Same contract as
    `lstm_scan_bwd_plain`. Scratch is allocated per call and freed after:
    at T=313, B=16, H=300 in f32 the resident body's peak is 72 MB of
    coefficients and 46 MB of dU partials."""
    t, d, b, hidden = _lstm_shape(xp)
    cuda_lib.check(xp, "xp", _DTYPES)
    cuda_lib.check(wh, "wh", (xp.dtype,), (d, hidden, 4 * hidden))
    for name, arg in (("hprev", hprev), ("cprev", cprev), ("cs", cs),
                      ("dhs", dhs)):
        cuda_lib.check(arg, name, (xp.dtype,), (t, d, b, hidden))
    dev = xp.device
    chosen = body or rnn_body(hidden, b, d, _sms(dev), backward=True)
    f32 = dict(dtype=torch.float32, device=dev)
    dxp = torch.empty_like(xp)
    du = torch.empty((d, hidden, 4 * hidden), **f32)
    du_part = _du_partials(d, hidden, 4 * hidden, dev)
    wht = dc = work = tickets = groups = chunk = 0
    if chosen != BODY_STEPWISE:
        work = torch.empty((t, d, b, hidden, 6), **f32)   # the coefficients
        tickets, groups, chunk = _resident_scratch(dev, hidden, b, d)
    else:
        wht = torch.empty((d, 4 * hidden, hidden), dtype=xp.dtype, device=dev)
        dc = torch.empty((d, b, hidden), **f32)
    cuda_lib.launch("lstm_bwd", dev, xp, wh, hprev, cprev, cs, dhs, dxp, du,
                    wht, dc, work, du_part, tickets, du_part.shape[0], groups,
                    chunk, t, d, b, hidden, int(xp.dtype == torch.bfloat16),
                    _BODY_CODES[chosen])
    BODY_LAUNCHES["lstm_bwd", chosen] += 1
    return dxp, du.to(wh.dtype)
