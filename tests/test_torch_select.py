"""Speaker-channel selection (dl4ss_tpu_torch.objectives.select) against
the JAX reference on the CPU, on the same numpy inputs. Probabilities are
permutations of distinct values, so no tie can make the two packages'
sorts disagree; the outputs are indices and 0/1 gates and must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl4ss_tpu.objectives import select as jsel
from dl4ss_tpu_torch.objectives import select as tsel


def _probs(seed, b=5, s=17):
    """(B, S) distinct probabilities in (0, 1), a fresh order per row."""
    rng = np.random.default_rng(seed)
    base = (np.arange(s) + 0.5) / s
    return np.stack([rng.permutation(base) for _ in range(b)]).astype(
        np.float32)


@pytest.mark.parametrize("alpha,top_k", [(0.5, 2), (0.9, 3), (0.0, 1)])
def test_top_k_mask_matches_jax(alpha, top_k):
    probs = _probs(0)
    ref = jsel.top_k_mask(jnp.asarray(probs), alpha, top_k)
    ours = tsel.top_k_mask(torch.as_tensor(probs), alpha, top_k)
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert ours.sum(dim=-1).max() <= top_k


@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_top_k_indices_matches_jax(top_k):
    probs = _probs(1)
    ref_idx, ref_val = jsel.top_k_indices(jnp.asarray(probs), top_k)
    idx, val = tsel.top_k_indices(torch.as_tensor(probs), top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(val.numpy(), np.asarray(ref_val))


@pytest.mark.parametrize("top_k", [2, 3])
def test_candidate_restricted_select_matches_jax(top_k):
    probs = _probs(2)
    cand = np.random.default_rng(3).random(probs.shape) < 0.4
    cand[:, :top_k] = True              # every row has at least top_k
    ref = jsel.candidate_restricted_select(jnp.asarray(probs),
                                           jnp.asarray(cand), top_k)
    ours = tsel.candidate_restricted_select(torch.as_tensor(probs),
                                            torch.as_tensor(cand), top_k)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert all(cand[b, i] for b, row in enumerate(ours.tolist())
               for i in row)


@pytest.mark.parametrize("alpha,top_k,fallback", [
    (0.15, 2, True), (0.9, 2, True), (0.9, 2, False), (0.5, 3, True)])
def test_cosine_dedup_select_matches_jax(alpha, top_k, fallback):
    """The greedy dedup against JAX's static-shape scan, at a loose and a
    tight distance bar (at 0.9 most candidates conflict, so the 2-mix
    fallback and the fill-in-visit-order rule are exercised)."""
    probs = _probs(4, b=6, s=12)
    emb = np.random.default_rng(5).standard_normal((12, 8)).astype(
        np.float32)
    emb[3] = emb[7] * 1.5 + 0.01        # a near-duplicate pair
    ref = jsel.cosine_dedup_select(jnp.asarray(probs), jnp.asarray(emb),
                                   alpha, top_k, fallback)
    ours = tsel.cosine_dedup_select(torch.as_tensor(probs),
                                    torch.as_tensor(emb), alpha, top_k,
                                    fallback)
    assert tuple(ours.shape) == (6, top_k)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_candidate_pools_contract():
    """`jax.random` streams cannot be reproduced, so the rosters are held
    to the function's contract, which the JAX function meets too: every
    live true speaker is a member, no dead one is forced in, each row has
    exactly max(n_candidates, live count) members, and a seed reproduces
    the draw."""
    rng = np.random.default_rng(6)
    b, k, s, n_cand = 8, 3, 20, 5
    spk = np.stack([rng.permutation(s)[:k] for _ in range(b)])
    live = rng.random((b, k)) < 0.7
    live[:, 0] = True
    live[0] = True
    ours = tsel.candidate_pools(torch.Generator().manual_seed(0),
                                torch.as_tensor(spk), torch.as_tensor(live),
                                n_cand, s)
    again = tsel.candidate_pools(torch.Generator().manual_seed(0),
                                 torch.as_tensor(spk), torch.as_tensor(live),
                                 n_cand, s)
    other = tsel.candidate_pools(torch.Generator().manual_seed(1),
                                 torch.as_tensor(spk), torch.as_tensor(live),
                                 n_cand, s)
    ref = np.asarray(jsel.candidate_pools(
        jax.random.PRNGKey(0), jnp.asarray(spk), jnp.asarray(live), n_cand,
        s))
    assert ours.dtype == torch.bool and tuple(ours.shape) == (b, s)
    assert torch.equal(ours, again) and not torch.equal(ours, other)
    for pools in (ours.numpy(), ref):
        for row in range(b):
            true = set(spk[row][live[row]].tolist())
            members = set(np.nonzero(pools[row])[0].tolist())
            assert true <= members
            assert len(members) == max(n_cand, len(true))
    # more true speakers than the roster size: the roster is the true set
    few = tsel.candidate_pools(torch.Generator().manual_seed(0),
                               torch.as_tensor(spk), torch.ones((b, k)), 2, s)
    assert few.sum(dim=-1).tolist() == [k] * b
