"""The wgmma mask-head kernels' order of work (csrc/maskhead_tile.cuh, K3 and
K6), mirrored in plain torch, against the plain versions and against the
JAX Pallas kernels in interpret mode, on the CPU.

The kernels cannot run here; `ops.maskhead_kernels` repeats what they do in
their own order: W packed into swizzled (tile, stage) slabs, 64-row units of
one utterance against column tiles of whole E-groups, the E-contraction as
a product of the bf16-rounded g*q with the 0/1 block-sum matrix S, and dq
and db as per-unit partials summed in a fixed order. The card tests
(tests/test_torch_cuda.py) hold the kernels to these mirrors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl4ss_tpu.ops.pallas_maskhead import _bwd_vjp, fused_dot_masks
from dl4ss_tpu_torch.ops import maskhead_kernels as m

# (B, T, D, F, E, K): ragged T (70, 129, 33, 140 leave a partial last unit),
# odd B (the last item's second unit past the batch), D of 24, 37, 40, 48
# and 64 (one or two stages), E of 5 (16 groups a tile, the cap: two tiles
# of 16 and 4 groups), 16, 20, 50 and 256 (one group a tile), K of 1, 2, 3
SHAPES = [(1, 70, 24, 13, 5, 3), (2, 129, 48, 13, 50, 2),
          (3, 5, 40, 7, 16, 1), (2, 33, 37, 10, 20, 2),
          (3, 140, 64, 3, 256, 2), (2, 100, 40, 20, 5, 3)]


def _inputs(b, t, d, f, e, k, seed=0):
    rng = np.random.default_rng(seed)
    s = 1 / np.sqrt(d)
    return (rng.uniform(-1, 1, (b, t, d)).astype(np.float32),
            rng.uniform(-s, s, (d, f * e)).astype(np.float32),
            rng.uniform(-s, s, f * e).astype(np.float32),
            rng.standard_normal((b, k, e)).astype(np.float32))


def _torch(h, w, b, q):
    return (torch.as_tensor(h).to(torch.bfloat16), torch.as_tensor(w),
            torch.as_tensor(b), torch.as_tensor(q).to(torch.bfloat16))


def _rel(a, r):
    a = np.asarray(torch.as_tensor(np.asarray(a, np.float32)), np.float64)
    r = np.asarray(np.asarray(r, np.float32), np.float64)
    return np.linalg.norm(a - r) / np.linalg.norm(r)


@pytest.mark.parametrize("d,f,e,want", [(600, 129, 50, (5, 26, 10)),
                                        (24, 13, 5, (13, 1, 1)),
                                        (64, 3, 256, (1, 3, 1)),
                                        (37, 10, 20, (10, 1, 1)),
                                        (65, 129, 1, (16, 9, 2))])
def test_tile_geometry(d, f, e, want):
    """ft whole E-groups a tile (at most 256 columns and 16 groups), the
    tiles, and the 64-deep stages over D."""
    assert m.tile_geometry(d, f, e) == want


def test_tile_geometry_refuses_wide_embeddings():
    with pytest.raises(ValueError):
        m.tile_geometry(8, 3, 257)


@pytest.mark.parametrize("b,t,d,f,e,k", SHAPES)
def test_pack_mirror_layout(b, t, d, f, e, k):
    """Slab (j, s) row n of the packed W holds W[64s : 64s+64, j*ft*E + n]
    with its 16-byte chunks swizzled (chunk c at c ^ (n % 8)), zeros past D
    and past the tile's columns; unpacking gives bf16(W) back exactly."""
    w = torch.as_tensor(_inputs(b, t, d, f, e, k)[1])
    ft, ntiles, nslices = m.tile_geometry(d, f, e)
    wt = m.pack_w_mirror(w, f, e)
    assert wt.dtype == torch.bfloat16
    assert wt.numel() == ntiles * nslices * m.TILE_COLS * m.TILE_INNER
    wl = m._unpack(wt, d, f, e)            # (ntiles, nslices*64, 256)
    nc = ft * e
    for j in range(ntiles):
        cols = min(nc, f * e - j * nc)
        torch.testing.assert_close(
            wl[j, :d, :cols], w[:, j * nc:j * nc + cols].to(
                torch.bfloat16).float(), atol=0, rtol=0)
        assert not wl[j, d:].any() and not wl[j, :, cols:].any()
    # the first slab's row 1: chunk c of W's inner rows sits at chunk c ^ 1
    slab = wt[:m.TILE_COLS * m.TILE_INNER].reshape(m.TILE_COLS, m.TILE_INNER)
    col1 = torch.zeros(m.TILE_INNER, dtype=torch.bfloat16)
    col1[:min(d, 64)] = w[:64, 1].to(torch.bfloat16)
    assert torch.equal(slab[1].reshape(8, 8)[[1, 0, 3, 2, 5, 4, 7, 6]],
                       col1.reshape(8, 8))


@pytest.mark.parametrize("b,t,d,f,e,k", SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_tile_mirror_fwd_matches_plain(b, t, d, f, e, k, out_dtype):
    """K3's order of work against its plain version: the same rounding
    points; the projection and the E-sum are summed in another order, and
    where that flips one bf16 rounding of a g*q term the mask moves by at
    most 2^-8 of a term below 4 times the sigmoid's slope 0.25: 7.5e-3."""
    h, w, bias, q = _torch(*_inputs(b, t, d, f, e, k, seed=1))
    got = m.fused_dot_masks_tile_mirror(h, m.pack_w_mirror(w, f, e), bias, q,
                                        f, e, out_dtype)
    ref = m.fused_dot_masks_plain(h, w, bias, q, f, e, out_dtype)
    assert got.shape == ref.shape == (b, k, t, f) and got.dtype == out_dtype
    torch.testing.assert_close(got.float(), ref.float(), atol=7.5e-3, rtol=0)


@pytest.mark.parametrize("b,t,d,f,e,k", [SHAPES[0], SHAPES[3], SHAPES[5]])
def test_tile_mirror_fwd_matches_the_pallas_kernel(b, t, d, f, e, k):
    """Against `fused_dot_masks` of the JAX package (its Pallas kernel in
    interpret mode: bf16 operands, f32 accumulation, bf16 g*q, the E-sum
    as `gk @ S`), on the same numpy inputs: the repo's 2e-2 bar for a bf16
    kernel (tests/test_pallas.py), and the 7.5e-3 of one flipped rounding."""
    hn, wn, bn, qn = _inputs(b, t, d, f, e, k, seed=2)
    ref = np.asarray(fused_dot_masks(*map(jnp.asarray, (hn, wn, bn, qn)),
                                     f, e))
    h, w, bias, q = _torch(hn, wn, bn, qn)
    got = m.fused_dot_masks_tile_mirror(h, m.pack_w_mirror(w, f, e), bias, q,
                                        f, e, torch.float32).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-2)
    np.testing.assert_allclose(got, ref, atol=7.5e-3)


def _bwd_inputs(b, t, d, f, e, k, seed):
    h, w, bias, q = _torch(*_inputs(b, t, d, f, e, k, seed=seed))
    rng = np.random.default_rng(seed + 100)
    masks = torch.as_tensor(rng.uniform(0, 1, (b, k, t, f)).astype(
        np.float32)).to(torch.bfloat16)
    dout = torch.as_tensor(rng.standard_normal((b, k, t, f)).astype(
        np.float32)).to(torch.bfloat16)
    return h, w, bias, q, masks, dout


@pytest.mark.parametrize("b,t,d,f,e,k", SHAPES)
def test_tile_mirror_bwd_matches_plain(b, t, d, f, e, k):
    """K6's order of work (per-unit dq and db partials, summed in a fixed
    order) against its plain version: dacc, dq and db within K6's 1e-2
    relative L2 (one flipped bf16 rounding where g differs by summation
    order); db against the f32 sum of the mirror's own dacc within 1e-5
    (summation order only)."""
    h, w, bias, q, masks, dout = _bwd_inputs(b, t, d, f, e, k, seed=3)
    got = m.fused_dot_masks_bwd_tile_mirror(h, m.pack_w_mirror(w, f, e),
                                            bias, q, masks, dout, f, e)
    ref = m.fused_dot_masks_bwd_plain(h, w, bias, q, masks, dout, f, e)
    assert got[0].dtype == torch.bfloat16 and got[0].shape == (b, t, f * e)
    assert got[1].shape == (b, k, e) and got[2].shape == (f * e,)
    for name, a, r in zip(("dacc", "dq", "db"), got, ref):
        assert _rel(a.float(), r.float()) < 1e-2, name
    assert _rel(got[2], got[0].float().sum((0, 1))) < 1e-5


@pytest.mark.parametrize("b,t,d,f,e,k", [SHAPES[0], SHAPES[1], SHAPES[3]])
def test_tile_mirror_bwd_matches_the_pallas_vjp(b, t, d, f, e, k):
    """Against the JAX package's VJP (`_bwd_vjp`: the Pallas `_bwd_kernel`
    in interpret mode, then its dW, dh and db products) on the same bf16
    residuals: dh and dW through `dacc_products`, db and dq from the
    mirror, all within 1e-2 relative L2 (the same rounding points; the
    JAX side keeps dq's accumulation across its 64-row tiles in f32 too)."""
    h, w, bias, q, masks, dout = _bwd_inputs(b, t, d, f, e, k, seed=4)
    bf = jnp.bfloat16
    res = (jnp.asarray(h.float().numpy(), bf), jnp.asarray(w.numpy()),
           jnp.asarray(bias.numpy()), jnp.asarray(q.float().numpy(), bf),
           jnp.asarray(masks.float().numpy(), bf))
    dh_r, dw_r, db_r, dq_r = _bwd_vjp(f, e, 64, res,
                                      jnp.asarray(dout.float().numpy(), bf))
    dacc, dq, db = m.fused_dot_masks_bwd_tile_mirror(
        h, m.pack_w_mirror(w, f, e), bias, q, masks, dout, f, e)
    dh, dw = m.dacc_products(h, w, dacc)
    for name, a, r in (("dh", dh, dh_r), ("dW", dw, dw_r), ("db", db, db_r),
                       ("dq", dq, dq_r)):
        assert _rel(a, np.asarray(r, np.float32)) < 1e-2, name


@pytest.mark.parametrize("d", [37, 40])
def test_kernel_rows_pads_only_odd_widths(d):
    """The kernels stage h 16 bytes a copy: a width that is no multiple of
    8 is copied with zero columns up to the next one; D = 40 is read in
    place."""
    h = torch.randn(2, 3, d).to(torch.bfloat16)
    got = m._kernel_rows(h)
    if d % 8 == 0:
        assert got is h
    else:
        assert got.shape == (2, 3, 40) and got.is_contiguous()
        assert torch.equal(got[..., :d], h) and not got[..., d:].any()


def test_dacc_products_on_the_cpu_are_the_f32_products():
    """On CPU tensors `dacc_products` is `dacc_products_plain`; both agree
    with float64 products of the same bf16 values (a product of two bf16
    values is exact in f32: the difference is summation order)."""
    rng = np.random.default_rng(9)
    h16 = torch.as_tensor(rng.standard_normal((2, 37, 24)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.as_tensor(rng.standard_normal((24, 30)).astype(np.float32))
    dacc = torch.as_tensor(rng.standard_normal((2, 37, 30)).astype(
        np.float32)).to(torch.bfloat16)
    dh, dw = m.dacc_products(h16, w, dacc)
    dh_p, dw_p = m.dacc_products_plain(h16, w, dacc)
    assert torch.equal(dh, dh_p) and torch.equal(dw, dw_p)
    h64, a64 = h16.double().reshape(-1, 24), dacc.double().reshape(-1, 30)
    w64 = w.to(torch.bfloat16).double()
    assert _rel(dw, (h64.T @ a64).numpy()) < 1e-6
    assert _rel(dh.reshape(-1, 24), (a64 @ w64.T).numpy()) < 1e-6
