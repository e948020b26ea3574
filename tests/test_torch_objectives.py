"""The port's objectives, metrics, optimizers and schedules against the JAX
package (and optax) on the CPU, on the same numpy inputs. The losses and
metrics compute in f32 on both sides and differ by summation order only:
1e-5 (relative for the SI-SDR values in dB). The optimizers follow optax's
formulas; one factor per clip and the bias corrections taken in float64
keep them within 1e-6 of optax over several steps."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dl4ss_tpu import preset as jax_preset
from dl4ss_tpu.eval import sisdr as jsd
from dl4ss_tpu.objectives import losses as jl
from dl4ss_tpu.objectives import pit as jpit
from dl4ss_tpu.train.state import make_optimizer as jax_make_optimizer
from dl4ss_tpu.train.state import make_schedule as jax_make_schedule
from dl4ss_tpu_torch import preset
from dl4ss_tpu_torch.eval import sisdr as tsd
from dl4ss_tpu_torch.objectives import losses as tl
from dl4ss_tpu_torch.objectives import pit as tpit
from dl4ss_tpu_torch.train.state import make_optimizer, make_schedule


def _np(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(ours, ref, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("k", [2, 3])
def test_pit_loss_and_permute(k):
    pred, target = _np(4, k, 5, 6, seed=1), _np(4, k, 5, 6, seed=2)
    loss, perm = tpit.pit_loss(torch.as_tensor(pred), torch.as_tensor(target))
    rloss, rperm = jpit.pit_loss(jnp.asarray(pred), jnp.asarray(target))
    _close(loss, rloss)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(rperm))
    _close(tpit.pit_permute(torch.as_tensor(pred), perm),
           jpit.pit_permute(jnp.asarray(pred), rperm), atol=0)


@pytest.mark.parametrize("name", ["mask_mse", "mask_mse_w", "sum_to_one",
                                  "complex_mse", "complex_mse_w",
                                  "softmargin", "gan_d", "gan_g"])
def test_losses_match_jax(name):
    a, b = _np(2, 3, 4, 5, seed=3), _np(2, 3, 4, 5, seed=4)
    ri_a, ri_b = _np(2, 3, 4, 5, 2, seed=5), _np(2, 3, 4, 5, 2, seed=6)
    w = np.array([[1, 0, 1], [1, 1, 0]], np.float32)
    logits, y = _np(4, 7, seed=7), (_np(4, 7, seed=8) > 0).astype(np.float32)
    cases = {
        "mask_mse": ("mask_mse_loss", (a, b)),
        "mask_mse_w": ("mask_mse_loss", (a, b, w)),
        "sum_to_one": ("sum_to_one_loss", (a,)),
        "complex_mse": ("complex_mse_loss", (ri_a, ri_b)),
        "complex_mse_w": ("complex_mse_loss", (ri_a, ri_b, w)),
        "softmargin": ("multilabel_softmargin_loss", (logits, y)),
        "gan_d": ("gan_d_loss", (a, b)),
        "gan_g": ("gan_g_loss", (a,)),
    }
    fn, args = cases[name]
    _close(getattr(tl, fn)(*map(torch.as_tensor, args)),
           getattr(jl, fn)(*map(jnp.asarray, args)))


def test_si_sdr_and_sdr_simple():
    est, ref = _np(3, 2, 400, seed=9), _np(3, 2, 400, seed=10)
    est = ref + 0.3 * est
    for fn in ("si_sdr", "sdr_simple"):
        _close(getattr(tsd, fn)(torch.as_tensor(est), torch.as_tensor(ref)),
               getattr(jsd, fn)(jnp.asarray(est), jnp.asarray(ref)),
               atol=1e-5, rtol=1e-5)
    _close(tsd.si_sdr(torch.as_tensor(est), torch.as_tensor(ref),
                      zero_mean=False),
           jsd.si_sdr(jnp.asarray(est), jnp.asarray(ref), zero_mean=False),
           atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("with_live", [False, True])
def test_si_sdr_pit(k, with_live):
    ref = _np(4, k, 300, seed=11)
    est = ref[:, ::-1] + 0.5 * _np(4, k, 300, seed=12)
    live = np.ones((4, k), bool)
    live[1, -1] = live[3, 0] = False
    ref[~live] = 0.0
    kw_t = dict(live=torch.as_tensor(live)) if with_live else {}
    kw_j = dict(live=jnp.asarray(live)) if with_live else {}
    scores, perm = tsd.si_sdr_pit(torch.as_tensor(est.copy()),
                                  torch.as_tensor(ref), **kw_t)
    rscores, rperm = jsd.si_sdr_pit(jnp.asarray(est), jnp.asarray(ref),
                                    **kw_j)
    _close(scores, rscores, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(rperm))


@pytest.mark.parametrize("schedule", ["constant", "cosine",
                                      "halve_per_epoch", "halve_50"])
def test_schedules_match_jax(schedule):
    over = dict(lr_schedule=schedule, max_epoch=120, learning_rate=3e-3)
    ours = make_schedule(preset("synth_tiny").replace(**over), 7)
    ref = jax_make_schedule(jax_preset("synth_tiny").replace(**over), 7)
    for step in (0, 1, 6, 7, 20, 349, 350, 700, 839, 840, 5000):
        got = ours(step) if callable(ours) else ours
        want = float(ref(jnp.asarray(step)) if callable(ref) else ref)
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-7), (step, got,
                                                                 want)


@pytest.mark.parametrize("optimizer", ["adam", "nadam"])
@pytest.mark.parametrize("clip", [0.0, 3.0])
def test_optimizer_matches_optax(optimizer, clip):
    """Four updates on the same gradients, some above the clip norm and
    some below it, on a halving schedule: parameters and the returned
    (pre-clip) global norm within 1e-6 of optax."""
    over = dict(optimizer=optimizer, grad_clip_norm=clip,
                lr_schedule="halve_per_epoch", learning_rate=1e-2)
    opt = make_optimizer(preset("synth_tiny").replace(**over), 2)
    jopt = jax_make_optimizer(jax_preset("synth_tiny").replace(**over), 2)
    params = {"a": _np(5, 3, seed=13), "b": _np(4, seed=14)}
    tparams = [torch.as_tensor(params["a"].copy()),
               torch.as_tensor(params["b"].copy())]
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state, jstate = opt.init(tparams), jopt.init(jparams)
    for i, scale in enumerate((0.5, 4.0, 0.1, 10.0)):
        grads = {"a": scale * _np(5, 3, seed=20 + i),
                 "b": scale * _np(4, seed=30 + i)}
        norm = opt.update(tparams, [torch.as_tensor(grads["a"].copy()),
                                    torch.as_tensor(grads["b"].copy())],
                          state)
        jg = {k: jnp.asarray(v) for k, v in grads.items()}
        updates, jstate = jopt.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        _close(norm, optax.global_norm(jg), atol=0, rtol=1e-6)
        for t, key in zip(tparams, ("a", "b")):
            _close(t, jparams[key], atol=1e-6)
    assert state.count == 4
