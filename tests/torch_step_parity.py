"""One train step of the port against the JAX package's, shared by the
memory and query trainers' tests: the gradients each optimizer receives
(before the clip), recorded by leaf name, and the comparison of the
gradients and updates.

Adam's first step moves an element by lr * g / (|g| + 1e-8): an element
whose gradient lies within the two packages' round-off may move either
way. The update comparison leaves out the elements whose JAX gradient is
within SIGN_NOISE times the RMS of the leaf's port-vs-JAX gradient
difference; they may carry at most SIGN_HIDDEN of the leaf's gradient
(L2). These are the bounds of the card-vs-CPU step checks in
chip_smoke.py (`leaf_updates`)."""

import jax
import numpy as np
import optax

from dl4ss_tpu_torch.weights import export_jax_params, flatten_tree

SIGN_NOISE, SIGN_HIDDEN = 3.0, 1e-2


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def jax_step(trainer, make_step, state, feats):
    """Run `make_step()(state, feats)` of a JAX trainer module (its
    `make_optimizer` wrapped, a host callback reading the gradients):
    ((new state, metrics), gradients by leaf name)."""
    grads = {}
    real = trainer.make_optimizer

    def make(*args, **kwargs):
        opt = real(*args, **kwargs)

        def update(g, opt_state, params=None):
            jax.debug.callback(lambda x: grads.update(
                flatten_tree(np_tree(x))), g)
            return opt.update(g, opt_state, params)

        return optax.GradientTransformation(opt.init, update)

    trainer.make_optimizer = make
    try:
        out = make_step()(state, feats)
        jax.effects_barrier()
    finally:
        trainer.make_optimizer = real
    return out, grads


def torch_step(make_step, state, feats):
    """Run `make_step()(state, feats)` of a port trainer (the
    `Optimizer.update` it calls wrapped): ((new state, metrics),
    gradients by leaf name)."""
    from dl4ss_tpu_torch.train import state as state_mod
    grads = {}
    names = {id(p): n for n, p in state.model.named_parameters()}
    update = state_mod.Optimizer.update

    def recording(self, params, g, opt_state):
        for p, x in zip(params, g):
            grads[names[id(p)]] = x.detach().numpy().copy()
        return update(self, params, g, opt_state)

    state_mod.Optimizer.update = recording
    try:
        return make_step()(state, feats), grads
    finally:
        state_mod.Optimizer.update = update


def assert_step_matches(before, params_j, model_t, grads_j, grads_t,
                        grad_tol=1e-5, update_tol=1e-3, grads_ref=None):
    """Every leaf's gradient within `grad_tol` relative L2 of JAX's (of
    `grads_ref`'s when given) and its update within `update_tol` of JAX's
    on the elements outside the round-off band (the module docstring); a
    leaf JAX leaves unmoved stays unmoved."""
    grads_ref = grads_j if grads_ref is None else grads_ref
    ref = dict(flatten_tree(np_tree(params_j)))
    ours = dict(flatten_tree(export_jax_params(model_t)))
    assert set(ours) == set(ref) == set(grads_j) == set(grads_t)
    for name, value in ref.items():
        want, got = value - before[name], ours[name] - before[name]
        if not np.any(want):          # no gradient reaches it
            assert not np.any(got), name
            continue
        g_j, g_t = grads_j[name], grads_t[name]
        assert rel(g_t, grads_ref[name]) <= grad_tol, name
        noise = SIGN_NOISE * float(np.sqrt(np.mean((g_t - g_j) ** 2)))
        keep = (np.abs(g_j) > noise) | ((g_j == 0) & (g_t == 0))
        assert np.linalg.norm(g_j[~keep]) \
            <= SIGN_HIDDEN * np.linalg.norm(g_j), name
        assert rel(got[keep], want[keep]) < update_tol, name
