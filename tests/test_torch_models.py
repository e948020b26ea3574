"""Port models and the serving slice against the JAX reference on the CPU,
with the same weights (a JAX `init_separator` tree loaded into the port's
modules by `load_jax_params`) and the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl4ss_tpu import preset as jax_preset
from dl4ss_tpu.models import init_separator as jax_init_separator
from dl4ss_tpu.models import separate as jax_separate
from dl4ss_tpu.ops.pallas_stft import pallas_masked_istft, pallas_stft_features
from dl4ss_tpu_torch import preset
from dl4ss_tpu_torch.models import (Separator, init_classifier,
                                    init_embedding, init_encoder,
                                    init_mask_head, init_separator, separate)
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


def test_unported_paths_raise():
    cfg = preset("synth_tiny")
    model = init_separator(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="K7"):
        separate(model, torch.zeros((1, 4, 129)), cfg)
    with pytest.raises(NotImplementedError, match="P9"):
        init_separator(preset("tdaa"), device="cpu")


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
