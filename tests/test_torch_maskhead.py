"""Port mask heads (K3's plain version, the dot and align heads) against
the JAX reference on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl4ss_tpu import preset as jax_preset
from dl4ss_tpu.models.attention import apply_mask_head as jax_mask_head
from dl4ss_tpu.models.attention import init_mask_head as jax_init_head
from dl4ss_tpu.ops.pallas_maskhead import _reference_impl, fused_dot_masks
from dl4ss_tpu_torch import preset
from dl4ss_tpu_torch.models.attention import apply_mask_head, init_mask_head
from dl4ss_tpu_torch.ops.maskhead_kernels import fused_dot_masks as k3
from dl4ss_tpu_torch.weights import load_jax_params


def _inputs(seed, b=2, t=37, h2=24, f=13, e=5, k=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h2)).astype(np.float32),
            (0.1 * rng.standard_normal((h2, f * e))).astype(np.float32),
            (0.1 * rng.standard_normal(f * e)).astype(np.float32),
            rng.standard_normal((b, k, e)).astype(np.float32), f, e)


@pytest.mark.parametrize("t", [37, 170])
def test_k3_plain_matches_fused_dot_masks(t):
    """K3's plain version against the Pallas kernel (interpret mode), at
    one and two of its 160-row time tiles. The bar is the repo's 2e-2
    (tests/test_pallas.py) for a bf16 kernel; both sides round at the same
    points (bf16 operands, f32 accumulation, bf16 g*q), so they should
    agree far closer: reported by the second assertion."""
    h, w, b, q, f, e = _inputs(0, t=t)
    ref = np.asarray(fused_dot_masks(*map(jnp.asarray, (h, w, b, q)), f, e))
    ours = k3(*map(torch.as_tensor, (h, w, b, q)), f, e)
    assert tuple(ours.shape) == ref.shape == (2, 3, t, f)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-2)
    # same rounding points: only f32 summation order differs, which can
    # flip one bf16 rounding of a g*q term (one bf16 step, 2^-7 of a term
    # below 4) and so move a mask by at most 0.03 * 0.25; observed max
    # |diff| 1.2e-7 at both t here
    np.testing.assert_allclose(ours.numpy(), ref, atol=7.5e-3)


def test_k3_plain_near_f32_reference():
    """Against the f32 XLA computation it replaces (`_reference_impl`):
    bf16-rounding close, the same bar as the JAX kernel's own test."""
    h, w, b, q, f, e = _inputs(1)
    ref = np.asarray(_reference_impl(*map(jnp.asarray, (h, w, b, q)), f, e))
    ours = k3(*map(torch.as_tensor, (h, w, b, q)), f, e)
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-2)


def test_k3_bf16_hidden_gives_bf16_masks():
    h, w, b, q, f, e = _inputs(2)
    out = k3(torch.as_tensor(h).bfloat16(), torch.as_tensor(w),
             torch.as_tensor(b), torch.as_tensor(q), f, e)
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("head", ["dot", "align"])
def test_mask_heads_match_jax(head):
    cfg_j = jax_preset("synth_tiny").replace(mask_head=head, embedding_size=6)
    cfg_t = preset("synth_tiny").replace(mask_head=head, embedding_size=6)
    jp = jax_init_head(jax.random.PRNGKey(0), cfg_j)
    tp = init_mask_head(cfg_t, device="cpu")
    load_jax_params(tp, jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(3)
    emb = np.tanh(rng.standard_normal((2, 5, 7, 6))).astype(np.float32)
    q = rng.standard_normal((2, 2, 6)).astype(np.float32)
    ref = jax_mask_head(jp, jnp.asarray(emb), jnp.asarray(q), cfg_j)
    with torch.no_grad():
        ours = apply_mask_head(tp, torch.as_tensor(emb), torch.as_tensor(q),
                               cfg_t)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def test_crm_head_runs_and_bounds():
    """The tdaa_crm preset's cRM head runs: two K*tanh-bounded channels per
    mask from the two halves of the doubled query, the real half equal to
    the magnitude dot head's energy on the first half."""
    cfg = preset("tdaa_crm").replace(embedding_size=6)
    head = init_mask_head(cfg, device="cpu")
    rng = np.random.default_rng(4)
    emb = torch.as_tensor(np.tanh(rng.standard_normal((1, 3, 5, 6)))
                          .astype(np.float32))
    q = torch.as_tensor(rng.standard_normal((1, 2, 12)).astype(np.float32))
    out = apply_mask_head(head, emb, q, cfg)
    assert tuple(out.shape) == (1, 2, 3, 5, 2)
    assert float(out.abs().max()) < cfg.crm_k
    mag = apply_mask_head(head, emb, q[..., :6],
                          cfg.replace(is_complex_mask=False))
    torch.testing.assert_close(
        out[..., 0], cfg.crm_k * torch.tanh(torch.logit(mag)), atol=1e-4,
        rtol=1e-4)


@pytest.mark.parametrize("t", [37, 170])
def test_fused_dot_masks_grads_match_jax(t):
    """Gradients w.r.t. (h, W, b, q) of <masks, cot>: the port's
    autograd.Function (K6's plain version for dacc and dq, then the plain
    products for dW, dh and db) against jax.grad of fused_dot_masks, whose
    backward is the Pallas `_bwd_kernel` in interpret mode. t=170 spans
    three 64-row backward tiles, so dq sums bf16-rounded per-tile column
    sums. Both sides round at the same points; the bar is the JAX kernel's
    own gradient test's (tests/test_pallas.py): rtol 5e-2, atol 4e-2."""
    h, w, b, q, f, e = _inputs(4, t=t)
    cot = np.random.default_rng(5).standard_normal((2, 3, t, f)).astype(
        np.float32)

    def loss(hh, ww, bb, qq):
        return jnp.sum(fused_dot_masks(hh, ww, bb, qq, f, e) * cot)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray,
                                                    (h, w, b, q)))
    leaves = [torch.as_tensor(a).requires_grad_() for a in (h, w, b, q)]
    (k3(*leaves, f, e) * torch.as_tensor(cot)).sum().backward()
    for name, leaf, r in zip(("h", "W", "b", "q"), leaves, ref):
        assert leaf.grad.dtype == torch.float32, name
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r),
                                   rtol=5e-2, atol=4e-2, err_msg=name)


def test_k6_plain_matches_pallas_bwd_kernel():
    """K6's plain version against the Pallas backward kernel's own outputs
    (`_bwd_vjp` before its outer products: dh = dacc W^T, so dacc is
    compared through dh, and dq and db = sum of dacc directly) on bf16
    operands, at two time tiles: same rounding points, 1e-2 relative L2."""
    from dl4ss_tpu.ops.pallas_maskhead import _bwd_vjp
    from dl4ss_tpu_torch.ops.maskhead_kernels import fused_dot_masks_bwd_plain
    h, w, b, q, f, e = _inputs(6, t=100)
    masks = np.random.default_rng(7).uniform(0, 1, (2, 3, 100, f)).astype(
        np.float32)
    dout = np.random.default_rng(8).standard_normal(masks.shape).astype(
        np.float32)
    bf = jnp.bfloat16
    res = (jnp.asarray(h, bf), jnp.asarray(w), jnp.asarray(b),
           jnp.asarray(q, bf), jnp.asarray(masks, bf))
    dh_ref, _, db_ref, dq_ref = _bwd_vjp(f, e, 64, res, jnp.asarray(dout, bf))
    tb = torch.bfloat16
    dacc, dq, db = fused_dot_masks_bwd_plain(
        torch.as_tensor(h).to(tb), torch.as_tensor(w), torch.as_tensor(b),
        torch.as_tensor(q).to(tb), torch.as_tensor(masks).to(tb),
        torch.as_tensor(dout).to(tb), f, e)
    assert dacc.dtype == tb and dq.dtype == torch.float32
    dh = torch.matmul(dacc.float(), torch.as_tensor(w).to(tb).float().T)

    def rel(a, r):
        r = np.asarray(r, np.float32)
        return np.linalg.norm(a.numpy() - r) / np.linalg.norm(r)
    assert rel(dh, dh_ref) < 1e-2
    assert rel(dq, dq_ref) < 1e-2
    assert rel(db, db_ref) < 1e-2
