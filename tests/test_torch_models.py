"""Port models and the serving slice against the JAX reference on the CPU,
with the same weights (a JAX `init_separator` tree loaded into the port's
modules by `load_jax_params`) and the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl4ss_tpu import preset as jax_preset
from dl4ss_tpu.models import apply_classifier as jax_apply_classifier
from dl4ss_tpu.models import init_separator as jax_init_separator
from dl4ss_tpu.models import separate as jax_separate
from dl4ss_tpu.models.separator import recursive_separate as jax_recursive
from dl4ss_tpu.ops.pallas_stft import pallas_masked_istft, pallas_stft_features
from dl4ss_tpu_torch import preset
from dl4ss_tpu_torch.models import (Separator, apply_classifier,
                                    classify_speakers, init_classifier,
                                    init_embedding, init_encoder,
                                    init_mask_head, init_separator,
                                    recursive_separate, separate)
from dl4ss_tpu_torch.models.common import linear_init
from dl4ss_tpu_torch.ops.rnn import rnn_init
from dl4ss_tpu_torch.serve import separate_waveforms
from dl4ss_tpu_torch.weights import flatten_tree, load_jax_params

FLAGS = dict(use_pallas_rnn=True, use_pallas_stft=True,
             use_pallas_maskhead=True)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(name, **overrides):
    """The same random model in both packages, and both configs."""
    cfg_j = jax_preset(name).replace(**overrides)
    cfg_t = preset(name).replace(**overrides)
    params = jax_init_separator(jax.random.PRNGKey(0), cfg_j)
    model = load_jax_params(Separator(cfg_t, device="cpu"),
                            _numpy_tree(params))
    return cfg_j, params, cfg_t, model


def test_load_jax_params_full_torch_multi_tree():
    """Every leaf of the full-width torch_multi tree, the classifier's
    included, lands under its own name with its own values."""
    cfg_j = jax_preset("torch_multi")
    tree = _numpy_tree(jax_init_separator(jax.random.PRNGKey(3), cfg_j))
    model = Separator(preset("torch_multi"), device="cpu")
    load_jax_params(model, tree)
    leaves = dict(flatten_tree(tree))
    params = dict(model.named_parameters())
    assert set(leaves) == set(params)
    assert "encoder.rnn.1.bwd.wh" in params and "classifier.out.w" in params
    assert tuple(params["encoder.proj.w"].shape) == (600, 129 * 50)
    for name, leaf in leaves.items():
        np.testing.assert_array_equal(params[name].detach().numpy(), leaf)


def test_load_jax_params_rejects_bad_trees():
    tree = _numpy_tree(jax_init_separator(jax.random.PRNGKey(0),
                                          jax_preset("synth_tiny")))
    model = Separator(preset("synth_tiny"), device="cpu")
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["encoder"]["proj"]["w"] = bad["encoder"]["proj"]["w"][:, :-1]
    with pytest.raises(ValueError, match="encoder.proj.w"):
        load_jax_params(model, bad)
    missing = dict(tree, embedding={})
    with pytest.raises(ValueError, match="missing.*embedding.table"):
        load_jax_params(model, missing)
    extra = dict(tree, adjust={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="extra.*adjust.w"):
        load_jax_params(model, extra)


@pytest.mark.parametrize("flags", [False, True])
def test_separate_matches_jax(flags):
    """`separate` with given speakers against JAX, with the kernel flags
    off (f32 both sides: 1e-5) and on. With them on, both sides run the
    bf16 mask head with the same rounding points, but an f32
    summation-order difference can flip one bf16 rounding of a g*q term
    (one bf16 step, 2^-7 of a term below 4), which moves that mask by at
    most 0.03 * max sigmoid' = 7.5e-3: 1e-2 on masks and pred. The
    encoder hidden and the queries stay f32 on both routes: 1e-5."""
    over = FLAGS if flags else {}
    cfg_j, params, cfg_t, model = _pair("synth_tiny", **over)
    rng = np.random.default_rng(0)
    feat = np.abs(rng.standard_normal((2, 9, 129))).astype(np.float32)
    spk = np.array([[0, 1], [2, 3]])
    ref = jax_separate(params, jnp.asarray(feat), cfg_j,
                       spk_idx=jnp.asarray(spk))
    with torch.no_grad():
        ours = separate(model, torch.as_tensor(feat), cfg_t,
                        spk_idx=torch.as_tensor(spk))
    tol = 1e-2 if flags else 1e-5
    for a, b in ((ours.masks, ref.masks), (ours.pred, ref.pred)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol)
    for a, b in ((ours.hidden, ref.hidden), (ours.queries, ref.queries)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_separate_log_spectral_branch_matches_jax():
    cfg_j, params, cfg_t, model = _pair("synth_tiny", log_spectral=True)
    rng = np.random.default_rng(1)
    feat = rng.standard_normal((1, 6, 129)).astype(np.float32)
    ri = rng.standard_normal((1, 6, 129, 2)).astype(np.float32)
    ref = jax_separate(params, jnp.asarray(feat), cfg_j,
                       spk_idx=jnp.asarray([[4, 5]]), mix_ri=jnp.asarray(ri))
    with torch.no_grad():
        ours = separate(model, torch.as_tensor(feat), cfg_t,
                        spk_idx=torch.tensor([[4, 5]]),
                        mix_ri=torch.as_tensor(ri))
    np.testing.assert_allclose(ours.pred.numpy(), np.asarray(ref.pred),
                               atol=1e-5)


def test_whole_slice_matches_jax():
    """The serving slice end to end at synth_tiny with every kernel flag
    on: JAX pallas_stft_features -> separate -> pallas_masked_istft
    (interpret mode) against the port's separate_waveforms with the same
    weights. Both sides run the bf16 mask head with the same rounding
    points; a flipped bf16 rounding moves one mask by < 7.5e-3 (see
    test_separate_matches_jax), which reaches a waveform sample scaled by
    |X| * 2/L: 1e-3."""
    cfg_j, params, cfg_t, model = _pair("synth_tiny", **FLAGS)
    rng = np.random.default_rng(2)
    wav = rng.uniform(-1, 1, (2, cfg_j.max_len)).astype(np.float32)
    spk = np.array([[0, 1], [5, 2]])
    mag, re, im = pallas_stft_features(jnp.asarray(wav))
    out = jax_separate(params, mag, cfg_j, spk_idx=jnp.asarray(spk))
    ref = pallas_masked_istft(re, im, out.masks, length=cfg_j.max_len)
    ours = separate_waveforms(model, torch.as_tensor(wav), cfg_t,
                              torch.as_tensor(spk), length=cfg_t.max_len)
    assert tuple(ours.shape) == ref.shape == (2, 2, cfg_j.max_len)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-3)


def test_serving_kernel_route_matches_plain_route():
    """The same model through the kernel route (plain versions on CPU) and
    the flags-off route: the bf16 mask head keeps them within 2e-2 of the
    signal's scale."""
    cfg = preset("synth_tiny").replace(**FLAGS)
    model = init_separator(cfg, torch.Generator().manual_seed(0), "cpu")
    wav = torch.rand((2, cfg.max_len), generator=torch.Generator()
                     .manual_seed(1)) * 2 - 1
    spk = torch.tensor([[0, 1], [2, 3]])
    fused = separate_waveforms(model, wav, cfg, spk)
    plain = separate_waveforms(model, wav, preset("synth_tiny"), spk)
    assert fused.shape == plain.shape == (2, 2, 3968)
    assert float((fused - plain).norm() / plain.norm()) < 2e-2


def test_recursive_separate_refuses_the_log_domain():
    """The peel loop subtracts in the LINEAR magnitude domain: log-spectral
    features (and cRM models) are refused, as in JAX."""
    cfg = preset("synth_tiny")
    model = init_separator(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="LINEAR"):
        recursive_separate(model, torch.zeros((1, 4, 129)),
                           cfg.replace(log_spectral=True))
    with pytest.raises(ValueError, match="magnitude residuals"):
        recursive_separate(model, torch.zeros((1, 4, 129)),
                           cfg.replace(is_complex_mask=True))


def test_tdaa_presets_build_and_separate():
    """The tdaa, tdaa_crm and tdaa_recursive trees (at synth_tiny widths):
    ADDJUST and the discriminator where the preset has them, and a
    separation of the right shape from each."""
    for name in ("tdaa", "tdaa_crm", "tdaa_recursive"):
        cfg = preset(name).replace(hidden_units=8, embedding_size=4,
                                   num_speakers=5, max_len_seconds=0.25)
        model = init_separator(cfg, torch.Generator().manual_seed(0), "cpu")
        tops = {n.split(".")[0] for n, _ in model.named_parameters()}
        assert ("adjust" in tops) == cfg.is_self_tune
        assert ("discriminator" in tops) == cfg.use_discriminator
        feat = torch.rand((1, cfg.num_frames, cfg.freq_bins))
        ri = torch.rand((1, cfg.num_frames, cfg.freq_bins, 2))
        with torch.no_grad():
            out = separate(model, feat, cfg, spk_idx=torch.tensor([[0, 1]]),
                           mix_ri=ri)
        want = (1, 2, cfg.num_frames, cfg.freq_bins)
        assert tuple(out.pred.shape) == want + ((2,) if cfg.is_complex_mask
                                                else ())


@pytest.mark.parametrize("build", ["encoder", "classifier", "separator"])
def test_remat_matches_no_remat(build):
    """cfg.remat recomputes each recurrent layer in the backward (JAX's
    jax.checkpoint, here torch.utils.checkpoint): the builders and the
    functions that run the recurrences take it, and the values and
    gradients equal remat=False's. Under no_grad nothing is kept to
    recompute, and the values are the same."""
    from dl4ss_tpu_torch.models import (apply_classifier, init_classifier,
                                        init_encoder)
    from dl4ss_tpu_torch.models.encoder import encoder_hidden
    builders = {"encoder": init_encoder, "classifier": init_classifier,
                "separator": init_separator}
    cfg = preset("synth_tiny")
    feat = torch.rand((2, 5, cfg.freq_bins),
                      generator=torch.Generator().manual_seed(2))
    run = {"encoder": lambda m, c: encoder_hidden(m, feat, c),
           "classifier": lambda m, c: apply_classifier(m, feat, c),
           "separator": lambda m, c: separate(m, feat, c,
                                              spk_idx=torch.tensor(
                                                  [[0, 1], [2, 3]])).pred}
    results = []
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        model = builders[build](c, torch.Generator().manual_seed(1), "cpu")
        out = run[build](model, c)
        out.square().sum().backward()
        with torch.no_grad():
            again = run[build](model, c)
        results.append((out.detach(), again,
                        [p.grad for p in model.parameters()]))
    (o0, a0, g0), (o1, a1, g1) = results
    assert torch.equal(o0, o1) and torch.equal(a0, a1)
    for x, y in zip(g0, g1):
        assert (x is None and y is None) or torch.equal(x, y)


def _feat(seed, shape=(3, 12, 129)):
    return np.abs(np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


@pytest.mark.parametrize("kernel_route", [False, True])
@pytest.mark.parametrize("logits", [False, True])
def test_apply_classifier_matches_jax(kernel_route, logits):
    """The classifier (2-layer BiLSTM, mean over time, linear, sigmoid)
    from the same loaded params, probabilities and logits, on the plain
    route and on the kernel route (K7's plain version against the Pallas
    kernel in interpret mode). f32 both sides: 1e-5. With the load this
    also holds `load_jax_params` to the classifier's leaves."""
    cfg_j, params, cfg_t, model = _pair("synth_tiny",
                                        use_pallas_rnn=kernel_route)
    feat = _feat(10)
    ref = jax_apply_classifier(params["classifier"], jnp.asarray(feat),
                               cfg_j, logits=logits)
    with torch.no_grad():
        ours = apply_classifier(model.classifier, torch.as_tensor(feat),
                                cfg_t, logits=logits)
        same = classify_speakers(model, torch.as_tensor(feat), cfg_t,
                                 logits=logits)
    assert tuple(ours.shape) == ref.shape == (3, cfg_t.num_speakers)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
    torch.testing.assert_close(same, ours)


def test_classifier_widens_with_hidden_mult():
    """classifier_hidden_mult=2 (the TDAA forks) doubles the BiLSTM width;
    the kernel route takes it and agrees with JAX: 1e-5."""
    cfg_j, params, cfg_t, model = _pair(
        "synth_tiny", classifier_hidden_mult=2, use_pallas_rnn=True)
    assert model.classifier.rnn[0].fwd.wh.shape[0] == 2 * cfg_t.hidden_units
    feat = _feat(11, (2, 7, 129))
    ref = jax_apply_classifier(params["classifier"], jnp.asarray(feat), cfg_j)
    with torch.no_grad():
        ours = apply_classifier(model.classifier, torch.as_tensor(feat),
                                cfg_t)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("flags", [False, True])
def test_separate_with_classifier_selection_matches_jax(flags):
    """`separate` with no speakers given: the classifier's top-k picks
    them. Same probabilities (1e-5), the same selected speakers (the test
    checks that the top-k is separated by more than the tolerance, so no
    tie can flip it), the same queries and masks (1e-5 in f32; 1e-2 with
    the bf16 mask head, see test_separate_matches_jax)."""
    over = FLAGS if flags else {}
    cfg_j, params, cfg_t, model = _pair("synth_tiny", **over)
    feat = _feat(12)
    ref = jax_separate(params, jnp.asarray(feat), cfg_j)
    with torch.no_grad():
        ours = separate(model, torch.as_tensor(feat), cfg_t)
    probs = np.asarray(ref.probs)
    ranked = np.sort(probs, axis=-1)[:, ::-1]
    assert (ranked[:, :cfg_j.top_k] - ranked[:, 1:cfg_j.top_k + 1]
            ).min() > 1e-4
    np.testing.assert_allclose(ours.probs.numpy(), probs, atol=1e-5)
    np.testing.assert_allclose(ours.queries.numpy(), np.asarray(ref.queries),
                               atol=1e-6)
    tol = 1e-2 if flags else 1e-5
    np.testing.assert_allclose(ours.masks.numpy(), np.asarray(ref.masks),
                               atol=tol)
    np.testing.assert_allclose(ours.pred.numpy(), np.asarray(ref.pred),
                               atol=tol)
    # given speakers skip the classifier unless need_probs asks for it
    spk = torch.tensor([[0, 1]] * 3)
    with torch.no_grad():
        assert not separate(model, torch.as_tensor(feat), cfg_t,
                            spk_idx=spk).probs.any()
        forced = separate(model, torch.as_tensor(feat), cfg_t, spk_idx=spk,
                          need_probs=True)
    np.testing.assert_allclose(forced.probs.numpy(), probs, atol=1e-5)


@pytest.mark.parametrize("with_allowed", [False, True])
@pytest.mark.parametrize("kernel_route", [False, True])
def test_recursive_separate_matches_jax(with_allowed, kernel_route):
    """The peel loop against JAX from the same params: the same speaker
    per step and the same extracted spectra (f32 both sides, 1e-5; the
    recursive path uses the plain mask head on both), with and without a
    candidate roster. Three steps, so the already-extracted exclusion is
    exercised twice."""
    cfg_j, params, cfg_t, model = _pair(
        "synth_tiny", recursive_max_steps=3, use_pallas_rnn=kernel_route)
    feat = _feat(13)
    allowed = None
    if with_allowed:
        allowed = np.zeros((3, cfg_t.num_speakers), bool)
        allowed[:, [1, 4, 6, 7]] = True
    ref_x, ref_s = jax_recursive(
        params, jnp.asarray(feat), cfg_j,
        allowed=None if allowed is None else jnp.asarray(allowed))
    with torch.no_grad():
        ours_x, ours_s = recursive_separate(
            model, torch.as_tensor(feat), cfg_t,
            allowed=None if allowed is None else torch.as_tensor(allowed))
    assert tuple(ours_x.shape) == ref_x.shape == (3, 3, 12, 129)
    np.testing.assert_array_equal(ours_s.numpy(), np.asarray(ref_s))
    for row in ours_s.tolist():
        assert len(set(row)) == 3
        if with_allowed:
            assert set(row) <= {1, 4, 6, 7}
    np.testing.assert_allclose(ours_x.numpy(), np.asarray(ref_x), atol=1e-5)


def test_selected_serving_matches_given_speakers():
    """`select_and_separate` returns the classifier's top-k and the same
    waveforms as `separate_waveforms` given those speakers; the recursive
    program returns one finite waveform per peel step."""
    from dl4ss_tpu_torch.serve import (recursive_waveforms,
                                       select_and_separate)
    cfg = preset("synth_tiny").replace(**FLAGS)
    model = init_separator(cfg, torch.Generator().manual_seed(0), "cpu")
    wav = torch.rand((2, cfg.max_len), generator=torch.Generator()
                     .manual_seed(1)) * 2 - 1
    wavs, spk = select_and_separate(model, wav, cfg, length=cfg.max_len)
    assert tuple(spk.shape) == (2, cfg.top_k)
    torch.testing.assert_close(
        wavs, separate_waveforms(model, wav, cfg, spk, length=cfg.max_len))
    torch.testing.assert_close(
        wavs, separate_waveforms(model, wav, cfg, length=cfg.max_len))
    rec, steps = recursive_waveforms(model, wav, cfg, length=cfg.max_len)
    assert tuple(rec.shape) == (2, cfg.recursive_max_steps, cfg.max_len)
    assert tuple(steps.shape) == (2, cfg.recursive_max_steps)
    assert bool(torch.isfinite(rec).all())


def test_init_separator_is_seeded_and_device_checked():
    cfg = preset("synth_tiny")
    a = init_separator(cfg, torch.Generator().manual_seed(5), "cpu")
    b = init_separator(cfg, torch.Generator().manual_seed(5), "cpu")
    for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                  b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_separator(cfg)


@pytest.mark.parametrize("build", [
    lambda cfg, **kw: Separator(cfg, **kw),
    lambda cfg, **kw: init_separator(cfg, **kw),
    lambda cfg, **kw: init_encoder(cfg, **kw),
    lambda cfg, **kw: init_classifier(cfg, **kw),
    lambda cfg, **kw: init_embedding(cfg, **kw),
    lambda cfg, **kw: init_mask_head(cfg.replace(mask_head="align"), **kw),
    lambda cfg, **kw: rnn_init("gru", 4, 3, 1, **kw),
    lambda cfg, **kw: linear_init(4, 3, **kw),
], ids=["Separator", "init_separator", "init_encoder", "init_classifier",
        "init_embedding", "init_mask_head", "rnn_init", "linear_init"])
def test_builders_default_to_cuda(build):
    """Every public builder puts its parameters on `cuda` unless the caller
    passes device='cpu': without a GPU the default raises, never builds on
    the CPU silently."""
    cfg = preset("synth_tiny")
    module = build(cfg, device="cpu")
    assert {p.device.type for p in module.parameters()} == {"cpu"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(cfg)


def test_kernel_wrappers_reject_cpu_tensors():
    from dl4ss_tpu_torch.ops import rnn_kernels
    with pytest.raises(ValueError, match="CUDA tensor"):
        rnn_kernels.gru_scan_cuda(torch.zeros((2, 2, 1, 6)),
                                  torch.zeros((2, 2, 6)),
                                  torch.zeros((2, 1, 2)))


@pytest.mark.parametrize("compute_bf16", [False, True])
def test_kernel_route_backward_reaches_every_parameter(compute_bf16):
    """A loss on the kernel route (every kernel flag on; the same
    autograd.Functions that launch K2/K5 and K3/K6 on the card run their
    plain halves here) gives a non-zero gradient to every encoder,
    projection and embedding parameter, in f32 and in bf16 compute. It
    guards against a kernel output coming back detached from the graph."""
    cfg = preset("synth_tiny").replace(**FLAGS)
    model = init_separator(cfg, torch.Generator().manual_seed(0), "cpu")
    wav = torch.rand((2, cfg.max_len), generator=torch.Generator()
                     .manual_seed(1)) * 2 - 1
    from dl4ss_tpu_torch.ops.stft_kernels import stft_features
    feat, _, _ = stft_features(wav)
    dtype = torch.bfloat16 if compute_bf16 else torch.float32
    params = {n: p.to(dtype) for n, p in model.named_parameters()}
    out = torch.func.functional_call(
        model, params, (feat.to(dtype), cfg),
        dict(spk_idx=torch.tensor([[0, 1], [2, 3]])))
    out.pred.float().square().mean().backward()
    reached = {n: p.grad for n, p in model.named_parameters()
               if n.startswith(("encoder.", "embedding."))}
    assert any(n.startswith("encoder.rnn.") for n in reached)
    assert {"encoder.proj.w", "encoder.proj.b", "embedding.table"} <= set(
        reached)
    for name, grad in reached.items():
        assert grad is not None and bool(grad.abs().sum() > 0), name
