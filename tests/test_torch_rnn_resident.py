"""The resident body of the recurrent backward kernels K5 and K8, on the CPU.

The body itself (csrc/rnn_bwd_common.cuh) runs only on the card. Its
arithmetic, which differs from the plain reverse loop (the gates of every
step from one product, turned into coefficients; a chain that is linear in
the carried gradient; dU from partial sums over slices of the (t, b) axis;
db_n summed over t first), is mirrored step for step in plain torch by
`gru_bwd_resident_mirror` / `lstm_bwd_resident_mirror`. Here the mirrors are
held to the plain versions and to the gradients of the JAX kernels
(`pallas_gru_scan`, `pallas_lstm_scan`, whose backward passes are the Pallas
kernels in interpret mode), and the shape rule `rnn_body` to the shapes
the main path and the card tests use.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl4ss_tpu.ops.pallas_rnn import pallas_gru_scan, pallas_lstm_scan
from dl4ss_tpu_torch.ops import rnn_kernels as k

SHAPES = [(12, 1, 48), (7, 3, 37), (5, 17, 8)]       # (T, B, H)


def _inputs(cell, t, b, h, seed):
    gates = 3 if cell == "gru" else 4
    rng = np.random.default_rng(seed)
    s = 1 / np.sqrt(h)
    xp = rng.standard_normal((t, 2, b, gates * h)).astype(np.float32)
    wh = rng.uniform(-s, s, (2, h, gates * h)).astype(np.float32)
    bhn = rng.uniform(-s, s, (2, 1, h)).astype(np.float32)
    dhs = rng.standard_normal((t, 2, b, h)).astype(np.float32)
    return xp, wh, bhn, dhs


def _bwd_args(cell, xp, wh, bhn, dhs, dtype):
    """What the autograd.Function hands its backward: the forward's own hs
    (and cs) one step late."""
    xp, wh, dhs = (torch.as_tensor(a).to(dtype) for a in (xp, wh, dhs))
    if cell == "gru":
        bhn = torch.as_tensor(bhn)
        hs = k.gru_scan_plain(xp, wh, bhn)
        return xp, wh, bhn, torch.cat([torch.zeros_like(hs[:1]), hs[:-1]]), dhs
    hs, cs = k.lstm_scan_plain(xp, wh)
    zeros = torch.zeros_like(hs[:1])
    return (xp, wh, torch.cat([zeros, hs[:-1]]), torch.cat([zeros, cs[:-1]]),
            cs, dhs)


MIRROR = {"gru": k.gru_bwd_resident_mirror, "lstm": k.lstm_bwd_resident_mirror}
PLAIN = {"gru": k.gru_scan_bwd_plain, "lstm": k.lstm_scan_bwd_plain}
NAMES = {"gru": ("dxp", "dU", "db_n"), "lstm": ("dxp", "dU")}


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("t,b,h", SHAPES)
def test_resident_mirror_matches_the_plain_version_f32(cell, t, b, h):
    """f32: the mirror reorders products (dh*c_n for dh*(1-z)*(1-n^2)) and
    sums (dU by slices, db_n over t first): an ulp per factor, 1e-5."""
    args = _bwd_args(cell, *_inputs(cell, t, b, h, 20), torch.float32)
    for name, g, r in zip(NAMES[cell], MIRROR[cell](*args),
                          PLAIN[cell](*args)):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5, msg=name)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("t,b,h", SHAPES)
def test_resident_mirror_matches_the_plain_version_bf16(cell, t, b, h):
    """bf16: both round da to bf16 before the carry product and the dU sum
    and keep dxp in bf16; a reordered product can flip one of those
    roundings, which the chain carries back: 5e-2 relative L2, the repo's
    bar for bf16 kernel gradients."""
    args = _bwd_args(cell, *_inputs(cell, t, b, h, 21), torch.bfloat16)
    for name, g, r in zip(NAMES[cell], MIRROR[cell](*args),
                          PLAIN[cell](*args)):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        assert _rel(g, r) < 5e-2, name


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("t,b,h", SHAPES)
def test_gru_resident_mirror_matches_pallas_vjp(dtype, tol, t, b, h):
    """The GRU mirror against jax.vjp of pallas_gru_scan, whose backward is
    the Pallas `_gru_bwd_kernel` in interpret mode, on the JAX forward's own
    hs. f32: summation order and the reordered coefficient products, 1e-4
    (absolute and relative). bf16: 5e-2 relative L2, as above."""
    xp, wh, bhn, dhs = _inputs("gru", t, b, h, 22)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jargs = (jnp.asarray(xp, jdt), jnp.asarray(wh, jdt), jnp.asarray(bhn))
    hs, vjp = jax.vjp(pallas_gru_scan, *jargs)
    ref = vjp(jnp.asarray(dhs, jdt))
    hs = torch.as_tensor(np.array(hs, np.float32)).to(dtype)
    got = k.gru_bwd_resident_mirror(
        torch.as_tensor(xp).to(dtype), torch.as_tensor(wh).to(dtype),
        torch.as_tensor(bhn), torch.cat([torch.zeros_like(hs[:1]), hs[:-1]]),
        torch.as_tensor(dhs).to(dtype))
    for name, g, r in zip(NAMES["gru"], got, ref):
        r = torch.as_tensor(np.array(r, np.float32))
        assert tuple(g.shape) == tuple(r.shape), name
        if dtype == torch.float32:
            torch.testing.assert_close(g, r, atol=tol, rtol=tol, msg=name)
        else:
            assert _rel(g, r) < tol, name


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("t,b,h", SHAPES)
def test_lstm_resident_mirror_matches_pallas_vjp(dtype, tol, t, b, h):
    """The LSTM mirror against jax.vjp of pallas_lstm_scan (the Pallas
    `_lstm_bwd_kernel` in interpret mode). The mirror runs on the port's
    plain forward, whose hs and cs agree with the JAX kernel's to 1e-5 in
    f32 and 2e-2 in bf16 (tests/test_torch_rnn.py). Tolerances as for the
    GRU."""
    xp, wh, _, dhs = _inputs("lstm", t, b, h, 23)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    _, vjp = jax.vjp(pallas_lstm_scan, jnp.asarray(xp, jdt),
                     jnp.asarray(wh, jdt))
    ref = vjp(jnp.asarray(dhs, jdt))
    got = k.lstm_bwd_resident_mirror(
        *_bwd_args("lstm", xp, wh, None, dhs, dtype))
    for name, g, r in zip(NAMES["lstm"], got, ref):
        r = torch.as_tensor(np.array(r, np.float32))
        assert tuple(g.shape) == tuple(r.shape), name
        if dtype == torch.float32:
            torch.testing.assert_close(g, r, atol=tol, rtol=tol, msg=name)
        else:
            assert _rel(g, r) < tol, name


def test_du_partials_cover_a_ragged_last_slice():
    """T*B = 7 rows over DU_SPLIT slices: the last slices are short or
    empty, and the sum still equals the one product."""
    rng = np.random.default_rng(24)
    hp = torch.as_tensor(rng.standard_normal((7, 2, 1, 5)).astype(np.float32))
    da = torch.as_tensor(rng.standard_normal((7, 2, 1, 15)).astype(np.float32))
    torch.testing.assert_close(k._sum_du_partials(hp, da),
                               torch.einsum("tdbk,tdbg->dkg", hp, da),
                               atol=1e-5, rtol=1e-5)


# the main path (torch_multi: H=300, B=16 a step, f32 or bf16), the card
# tests' ragged shapes, batches in chunks of 20 rows up to the 7 launches
# measured, and shapes past what the resident body holds
@pytest.mark.parametrize("hidden,batch,body", [
    (300, 16, "resident"), (300, 1, "resident"), (300, 17, "resident"),
    (300, 20, "resident"), (8, 2, "resident"), (37, 1, "resident"),
    (45, 3, "resident"), (33, 1, "resident"), (304, 16, "resident"),
    (305, 1, "stepwise"), (600, 5, "stepwise"), (600, 16, "stepwise"),
    (300, 21, "resident"), (300, 128, "resident"), (300, 140, "resident"),
    (300, 141, "stepwise"), (8, 512, "resident")])
def test_rnn_bwd_body_rule(hidden, batch, body):
    """The backward's resident body takes H <= 304 (a block's 24 units of
    U^T in registers) while the batch needs at most 7 launches of the
    2 * ceil(rows / 4) * ceil(H / 24) blocks that fit the 132 SMs at once;
    every other shape gets the stepwise body."""
    assert k.rnn_body(hidden, batch, backward=True) == body
    assert {k.BODY_RESIDENT, k.BODY_STEPWISE} == {"resident", "stepwise"}


def test_rnn_bwd_body_counts_directions():
    assert k.rnn_body(300, 280, directions=1, backward=True) == "resident"
    assert k.rnn_body(300, 281, directions=1, backward=True) == "stepwise"
    assert k.resident_groups(16) == 8 and k.resident_groups(17, 1) == 5
