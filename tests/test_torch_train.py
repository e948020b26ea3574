"""The port's trainer against the JAX package's on the CPU: one train step
and one eval step from the same parameters (a JAX `create_train_state`
tree loaded into the port) on the same injected features (one JAX
`sample_mixtures` + `featurize` batch converted to numpy), the fused step,
mixed precision and the training CLI."""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl4ss_tpu import preset as jax_preset
from dl4ss_tpu.data.synth import featurize as jax_featurize
from dl4ss_tpu.data.synth import make_synthetic_bank as jax_bank
from dl4ss_tpu.data.synth import sample_mixtures as jax_sample
from dl4ss_tpu.train.state import create_train_state as jax_state
from dl4ss_tpu.train.steps import make_classifier_step as jax_classifier_step
from dl4ss_tpu.train.steps import make_eval_step as jax_eval_step
from dl4ss_tpu.train.steps import make_recursive_eval_step as jax_recursive_eval
from dl4ss_tpu.train.steps import make_train_step as jax_train_step
from dl4ss_tpu_torch import preset
from dl4ss_tpu_torch.models import Separator
from dl4ss_tpu_torch.train.state import create_train_state
from dl4ss_tpu_torch.train.steps import (make_classifier_step,
                                         make_eval_step, make_fused_step,
                                         make_recursive_eval_step,
                                         make_train_step)
from dl4ss_tpu_torch.weights import (export_jax_params, flatten_tree,
                                     load_jax_params)

FLAGS = dict(use_pallas_rnn=True, use_pallas_stft=True,
             use_pallas_maskhead=True)


def _setup(seed=0, **overrides):
    """Both configs, the JAX state, the port's state from the same params,
    and one batch of features as numpy."""
    cfg_j = jax_preset("synth_tiny").replace(**overrides)
    cfg_t = preset("synth_tiny").replace(**overrides)
    state_j = jax_state(jax.random.PRNGKey(seed), cfg_j)
    model = load_jax_params(Separator(cfg_t, device="cpu"),
                            jax.tree_util.tree_map(np.asarray,
                                                   state_j.params))
    state_t = create_train_state(cfg_t, device="cpu", model=model)
    bank = jnp.asarray(jax_bank(seed, cfg_j.num_speakers, 2, cfg_j.max_len))
    batch = jax_sample(jax.random.PRNGKey(seed + 1), bank, cfg_j)
    feats = {k: np.array(v) for k, v in jax_featurize(batch, cfg_j).items()}
    return cfg_j, state_j, cfg_t, state_t, feats


def _torch_feats(feats):
    return {k: torch.as_tensor(v) for k, v in feats.items()}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("flags,loss_tol,update_tol", [
    (False, 1e-4, 1e-4),
    (True, 2e-2, 5e-2),
])
def test_train_step_matches_jax(flags, loss_tol, update_tol):
    """Loss, grad norm and every parameter's update after one clipped-Adam
    step. With the kernel flags off both sides compute in f32: 1e-4. With
    them on, both run the bf16 mask head (forward and backward) at the
    same rounding points, but f32 summation order can flip single bf16
    roundings: 2e-2 on the loss and grad norm, 5e-2 relative L2 on each
    update, the repo's bars for bf16 kernels and their gradients. Updates
    rather than updated values: an Adam step moves a weight by ~lr, far
    below the weight itself, so the values alone would hide any error."""
    cfg_j, state_j, cfg_t, state_t, feats = _setup(**(FLAGS if flags
                                                       else {}))
    before = dict(flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                      state_j.params)))
    new_j, met_j = jax_train_step(cfg_j)(
        state_j, {k: jnp.asarray(v) for k, v in feats.items()})
    new_t, met_t = make_train_step(cfg_t)(state_t, _torch_feats(feats))
    assert new_t.step == 1
    for key in ("loss", "mask_loss", "grad_norm"):
        assert abs(float(met_t[key]) - float(met_j[key])) \
            <= loss_tol * abs(float(met_j[key])), key
    ref = dict(flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                   new_j.params)))
    ours = dict(flatten_tree(export_jax_params(new_t.model)))
    assert set(ours) == set(ref)
    for name, value in ref.items():
        want, got = value - before[name], ours[name] - before[name]
        if not np.any(want):          # the classifier: no gradient
            assert not np.any(got), name
            continue
        assert _rel(got, want) < update_tol, name


@pytest.mark.parametrize("flags,tol", [(False, 1e-4), (True, 5e-2)])
def test_eval_step_matches_jax(flags, tol):
    """Teacher-forced SI-SDR per utterance, in dB, from the same params
    and feats: f32 both sides (1e-4 dB), or the bf16 mask head on both
    (5e-2 dB)."""
    cfg_j, state_j, cfg_t, state_t, feats = _setup(
        seed=2, **(FLAGS if flags else {}))
    ref = jax_eval_step(cfg_j)(state_j.params,
                               {k: jnp.asarray(v) for k, v in feats.items()})
    ours = make_eval_step(cfg_t)(state_t.model, _torch_feats(feats))
    np.testing.assert_allclose(ours["si_sdr"].numpy(),
                               np.asarray(ref["si_sdr"]), atol=tol)
    np.testing.assert_array_equal(ours["perm"].numpy(),
                                  np.asarray(ref["perm"]))
    assert ours["pred_wavs"].shape == ref["pred_wavs"].shape


def test_bf16_compute_keeps_f32_masters():
    """compute_dtype=bfloat16: the step runs on bf16 casts, the masters
    and moments stay f32 and are updated; the loss agrees with the JAX
    bf16 step within 2e-2."""
    over = dict(FLAGS, compute_dtype="bfloat16")
    cfg_j, state_j, cfg_t, state_t, feats = _setup(seed=3, **over)
    before = {n: p.detach().clone()
              for n, p in state_t.model.named_parameters()}
    _, met_j = jax_train_step(cfg_j)(
        state_j, {k: jnp.asarray(v) for k, v in feats.items()})
    new_t, met_t = make_train_step(cfg_t)(state_t, _torch_feats(feats))
    for name, p in new_t.model.named_parameters():
        assert p.dtype == torch.float32, name
    assert all(m.dtype == torch.float32 for m in new_t.opt_state.mu)
    assert not torch.equal(before["encoder.proj.w"],
                           new_t.model.encoder.proj.w)
    assert abs(float(met_t["loss"]) - float(met_j["loss"])) \
        <= 2e-2 * abs(float(met_j["loss"]))


def test_fused_step_loss_falls():
    """Sample -> featurize -> step on the kernel route (plain versions on
    the CPU): finite losses that fall over a few steps on a small bank."""
    cfg = preset("synth_tiny").replace(learning_rate=3e-3, **FLAGS)
    state = create_train_state(cfg, seed=0, device="cpu")
    bank = torch.as_tensor(jax_bank(0, cfg.num_speakers, 2, cfg.max_len))
    step = make_fused_step(cfg)
    losses = []
    for _ in range(12):
        state, metrics = step(state, bank)
        losses.append(float(metrics["loss"]))
    assert state.step == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < 0.8 * np.mean(losses[:4]), losses


def test_train_cli_writes_its_metrics_line(tmp_path):
    metrics = tmp_path / "metrics.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "dl4ss_tpu_torch.run.train", "--preset",
         "synth_tiny", "--device", "cpu", "--epochs", "1", "--epoch-size",
         "2", "--metrics", str(metrics)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = metrics.read_text().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["kind"] == "epoch" and rec["step"] == 2
    assert np.isfinite([rec["loss"], rec["grad_norm"], rec["si_sdr"]]).all()
    assert "final SI-SDR" in proc.stdout


@pytest.mark.parametrize("argv,message", [
    (["--mode", "memory", "--noise-wavs", "noise"],
     "bank-mode street-noise"),
    (["--dis-sp"], "only applies to --mode adversarial"),
    (["--resume", "--checkpoint-dir", "ck", "--init-from", "ck"],
     "conflict"),
    (["--file-lists", "lists"], "Cocktail memory-mode"),
    (["--list-dir", "lists", "--noise-wavs", "noise"], "bank-mode"),
])
def test_train_cli_exits_with_a_one_line_message(argv, message):
    from dl4ss_tpu_torch.run import train as cli
    with pytest.raises(SystemExit, match=message):
        cli.main(["--preset", "synth_tiny", "--device", "cpu", *argv])


def _jnp_feats(feats):
    return {k: jnp.asarray(v) for k, v in feats.items()}


@pytest.mark.parametrize("over,loss_tol,update_tol", [
    ({}, 1e-5, 1e-3),
    (dict(use_pallas_rnn=True), 1e-5, 1e-3),
    (dict(use_pallas_rnn=True, compute_dtype="bfloat16"), 2e-2, 5e-2),
], ids=["plain", "kernel_route", "kernel_route_bf16"])
def test_classifier_step_matches_jax(over, loss_tol, update_tol):
    """One `make_classifier_step` from the same params and feats: loss,
    element_acc and every parameter's update. The plain route and the
    kernel route (K7 / K8's plain versions against the Pallas kernels in
    interpret mode) compute in f32 on both sides: 1e-5 on the loss; 1e-3
    relative L2 on each update, since Adam's first step divides g by
    (|g| + 1e-8) and so amplifies f32 round-off on the smallest
    gradients. bf16 compute: the repo's bars for bf16 kernels and their
    gradients, 2e-2 and 5e-2. Only the classifier moves."""
    cfg_j, state_j, cfg_t, state_t, feats = _setup(seed=4, **over)
    before = dict(flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                      state_j.params)))
    new_j, met_j = jax_classifier_step(cfg_j)(state_j, _jnp_feats(feats))
    new_t, met_t = make_classifier_step(cfg_t)(state_t, _torch_feats(feats))
    assert new_t.step == 1
    assert abs(float(met_t["loss"]) - float(met_j["loss"])) \
        <= loss_tol * abs(float(met_j["loss"]))
    # element_acc counts thresholded probabilities: allow one flip in bf16
    slack = 0.0 if loss_tol < 1e-3 else 1.0 / (cfg_t.batch_size
                                                * cfg_t.num_speakers)
    assert abs(float(met_t["element_acc"]) - float(met_j["element_acc"])) \
        <= slack + 1e-7
    ref = dict(flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                   new_j.params)))
    ours = dict(flatten_tree(export_jax_params(new_t.model)))
    moved = set()
    for name, value in ref.items():
        want, got = value - before[name], ours[name] - before[name]
        if not np.any(want):
            assert not np.any(got), name
            continue
        moved.add(name.split(".")[0])
        assert _rel(got, want) < update_tol, name
    assert moved == {"classifier"}


@pytest.mark.parametrize("complement", [False, True])
def test_eval_step_with_classifier_selection_matches_jax(complement):
    """`make_eval_step` with teacher_forced=False (the classifier's top-k
    selects the speakers) and with the complement mask (alpha raised so
    that every row has at most one speaker above it and the second channel
    becomes (1 - mask_1) * |X|): SI-SDR per utterance within 1e-4 dB, the
    same permutation, the same probabilities (1e-5). f32 both sides."""
    over = dict(alpha=0.9) if complement else {}
    cfg_j, state_j, cfg_t, state_t, feats = _setup(seed=5, **over)
    ref = jax_eval_step(cfg_j)(state_j.params, _jnp_feats(feats),
                               teacher_forced=False,
                               complement_mask=complement)
    ours = make_eval_step(cfg_t)(state_t.model, _torch_feats(feats),
                                 teacher_forced=False,
                                 complement_mask=complement)
    np.testing.assert_allclose(ours["si_sdr"].numpy(),
                               np.asarray(ref["si_sdr"]), atol=1e-4)
    np.testing.assert_array_equal(ours["perm"].numpy(),
                                  np.asarray(ref["perm"]))
    np.testing.assert_allclose(ours["probs"].numpy(),
                               np.asarray(ref["probs"]), atol=1e-5)
    if complement:
        assert (np.asarray(ref["probs"]) > 0.9).sum(axis=-1).max() <= 1
        plain = make_eval_step(cfg_t)(state_t.model, _torch_feats(feats),
                                      teacher_forced=False)
        assert not torch.allclose(plain["pred_wavs"][:, 1],
                                  ours["pred_wavs"][:, 1])
        torch.testing.assert_close(plain["pred_wavs"][:, 0],
                                   ours["pred_wavs"][:, 0])


@pytest.mark.parametrize("steps,roster", [(2, False), (3, True), (1, False)])
def test_recursive_eval_step_matches_jax(steps, roster):
    """`make_recursive_eval_step` against JAX: the same speakers per peel
    step, SI-SDR within 1e-4 dB, with as many, more and fewer steps than
    reference channels (the padding branches), and with a candidate roster
    in the feats."""
    cfg_j, state_j, cfg_t, state_t, feats = _setup(
        seed=6, recursive_max_steps=steps)
    if roster:
        allowed = np.zeros((cfg_t.batch_size, cfg_t.num_speakers), bool)
        allowed[:, [0, 2, 3, 5]] = True
        feats = dict(feats, candidates=allowed)
    ref = jax_recursive_eval(cfg_j)(state_j.params, _jnp_feats(feats))
    ours = make_recursive_eval_step(cfg_t)(state_t.model,
                                           _torch_feats(feats))
    np.testing.assert_array_equal(ours["spk_steps"].numpy(),
                                  np.asarray(ref["spk_steps"]))
    assert ours["pred_wavs"].shape == ref["pred_wavs"].shape
    np.testing.assert_allclose(ours["si_sdr"].numpy(),
                               np.asarray(ref["si_sdr"]), atol=1e-4)
    np.testing.assert_array_equal(ours["perm"].numpy(),
                                  np.asarray(ref["perm"]))
    if roster:
        assert set(ours["spk_steps"].flatten().tolist()) <= {0, 2, 3, 5}


def test_train_step_with_classifier_selected_channels():
    """ground_truth=False: the classifier selects the channels, so identity
    assignment is refused as in JAX, and a pit step matches JAX's loss
    (f32 both sides, 1e-4)."""
    with pytest.raises(ValueError, match="ill-posed"):
        make_train_step(preset("synth_tiny").replace(
            ground_truth=False, loss_mode="identity"))
    cfg_j, state_j, cfg_t, state_t, feats = _setup(
        seed=7, ground_truth=False, loss_mode="pit")
    _, met_j = jax_train_step(cfg_j)(state_j, _jnp_feats(feats))
    _, met_t = make_train_step(cfg_t)(state_t, _torch_feats(feats))
    assert abs(float(met_t["loss"]) - float(met_j["loss"])) \
        <= 1e-4 * abs(float(met_j["loss"]))
