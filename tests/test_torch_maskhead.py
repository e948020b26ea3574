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


def test_crm_head_raises_until_ported():
    cfg = preset("tdaa_crm")
    with pytest.raises(NotImplementedError, match="P9"):
        apply_mask_head(init_mask_head(cfg, device="cpu"), torch.zeros((1, 2, 3, 100)),
                        torch.zeros((1, 1, 100)), cfg)
