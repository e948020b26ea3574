"""TDAA in the port against the JAX package on the CPU: the cRM math,
ADDJUST, the discriminator, the cRM mask heads, the separator's TDAA paths,
the dense and adversarial trainers, the cRM eval step, the dis-sp real pool
and remat. Same inputs from a numpy seed, and the same parameter pytree
(a JAX `init_separator` / `create_train_state` tree through
`weights.load_jax_params`), at synth_tiny widths with the TDAA flags on."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl4ss_tpu import preset as jax_preset
from dl4ss_tpu.data.synth import featurize as jax_featurize
from dl4ss_tpu.data.synth import make_synthetic_bank as jax_bank
from dl4ss_tpu.data.synth import sample_mixtures as jax_sample
from dl4ss_tpu.data.synth import same_speaker_real_specs as jax_real_specs
from dl4ss_tpu.models import init_separator as jax_init_separator
from dl4ss_tpu.models import separate as jax_separate
from dl4ss_tpu.models.adjust import apply_adjust as jax_adjust
from dl4ss_tpu.models.adjust import init_adjust as jax_init_adjust
from dl4ss_tpu.models.attention import apply_mask_head as jax_mask_head
from dl4ss_tpu.models.attention import init_mask_head as jax_init_head
from dl4ss_tpu.models.discriminator import (
    apply_discriminator as jax_discriminator)
from dl4ss_tpu.models.discriminator import (
    init_discriminator as jax_init_discriminator)
from dl4ss_tpu.models.separator import recursive_separate as jax_recursive
from dl4ss_tpu.models.separator import separate_dense as jax_dense
from dl4ss_tpu.ops import crm as jax_crm
from dl4ss_tpu.train.state import create_train_state as jax_state
from dl4ss_tpu.train.steps import make_adversarial_step as jax_adv_step
from dl4ss_tpu.train.steps import make_dense_train_step as jax_dense_step
from dl4ss_tpu.train.steps import make_eval_step as jax_eval_step
from dl4ss_tpu.train.steps import make_train_step as jax_train_step
from dl4ss_tpu_torch import preset
from dl4ss_tpu_torch.data.synth import MixtureBatch, same_speaker_real_specs
from dl4ss_tpu_torch.models import Separator, init_separator, separate
from dl4ss_tpu_torch.models.adjust import apply_adjust, init_adjust
from dl4ss_tpu_torch.models.attention import apply_mask_head, init_mask_head
from dl4ss_tpu_torch.models.discriminator import (apply_discriminator,
                                                  init_discriminator)
from dl4ss_tpu_torch.models.separator import (recursive_separate,
                                              separate_dense)
from dl4ss_tpu_torch.ops import crm
from dl4ss_tpu_torch.train.state import create_train_state
from dl4ss_tpu_torch.train.steps import (make_adversarial_step,
                                         make_dense_train_step,
                                         make_eval_step, make_train_step)
from dl4ss_tpu_torch.weights import (export_jax_params, flatten_tree,
                                     load_jax_params)

TDAA = dict(encoder_rnn="lstm", is_self_tune=True, use_discriminator=True)
CRM = dict(encoder_rnn="lstm", is_self_tune=True, is_complex_mask=True)
KERNELS = dict(use_pallas_rnn=True, use_pallas_stft=True,
               use_pallas_maskhead=True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_crm_functions_match_jax():
    rng = np.random.default_rng(0)
    m = (rng.standard_normal((2, 3, 5, 7, 2)) * 4).astype(np.float32)
    x = rng.standard_normal((2, 1, 5, 7, 2)).astype(np.float32)
    c = (rng.uniform(-9.9, 9.9, m.shape)).astype(np.float32)
    spec = (rng.standard_normal((2, 5, 7))
            + 1j * rng.standard_normal((2, 5, 7))).astype(np.complex64)
    pairs = [
        (crm.crm_compress(_t(m)), jax_crm.crm_compress(jnp.asarray(m))),
        (crm.crm_uncompress(_t(c)), jax_crm.crm_uncompress(jnp.asarray(c))),
        (crm.complex_mask_apply(_t(m), _t(x)),
         jax_crm.complex_mask_apply(jnp.asarray(m), jnp.asarray(x))),
        (crm.pack_ri(_t(spec)), jax_crm.pack_ri(jnp.asarray(spec))),
    ]
    for ours, ref in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6,
                                   rtol=1e-6)
    np.testing.assert_array_equal(crm.unpack_ri(_t(x)).numpy(),
                                  np.asarray(jax_crm.unpack_ri(
                                      jnp.asarray(x))))
    # uncompress inverts compress inside the clip
    torch.testing.assert_close(crm.crm_uncompress(crm.crm_compress(_t(m))),
                               _t(m), atol=1e-3, rtol=1e-4)


def test_apply_adjust_matches_jax():
    cfg_j = jax_preset("synth_tiny").replace(is_self_tune=True)
    cfg_t = preset("synth_tiny").replace(is_self_tune=True)
    jp = jax_init_adjust(jax.random.PRNGKey(1), cfg_j)
    tp = load_jax_params(init_adjust(cfg_t, device="cpu"), _np(jp))
    rng = np.random.default_rng(1)
    hidden = rng.standard_normal((3, 11, 2 * cfg_t.hidden_units)
                                 ).astype(np.float32)
    q = rng.standard_normal((3, 2, cfg_t.query_dim)).astype(np.float32)
    ref = jax_adjust(jp, jnp.asarray(hidden), jnp.asarray(q))
    with torch.no_grad():
        ours = apply_adjust(tp, _t(hidden), _t(q))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("build", ["init_discriminator", "init_separator",
                                   "create_train_state"])
def test_discriminator_for_another_frame_count_matches_jax(build):
    """`num_frames` != cfg.num_frames (40 frames at 0.5 s, whose cfg says
    32) through each function that takes it, as JAX's: the discriminator's
    output layer sized for 40 frames, every leaf of the tree JAX's shape,
    the state's discriminator moments that size too, and its scores on
    (2, 2, 40, F) spectra within 1e-5 of JAX's from the same weights."""
    over = dict(use_discriminator=True, max_len_seconds=0.5)
    cfg_j = jax_preset("synth_tiny").replace(**over)
    cfg_t = preset("synth_tiny").replace(**over)
    assert cfg_t.num_frames == 32
    key = jax.random.PRNGKey(4)
    if build == "init_discriminator":
        jp = jax_init_discriminator(key, cfg_j, num_frames=40)
        tm = init_discriminator(cfg_t, device="cpu", num_frames=40)
    elif build == "init_separator":
        jp = jax_init_separator(key, cfg_j, num_frames=40)
        tm = init_separator(cfg_t, device="cpu", num_frames=40)
    else:
        state_j = jax_state(key, cfg_j, num_frames=40)
        jp = state_j.params
        state_t = create_train_state(cfg_t, device="cpu", num_frames=40)
        tm = state_t.model
        assert [tuple(m.shape) for m in state_t.d_opt_state.mu] == [
            tuple(p.shape) for p in tm.discriminator.parameters()]
    want = {k: np.asarray(v).shape for k, v in flatten_tree(jp)}
    assert {n: tuple(p.shape) for n, p in tm.named_parameters()} == want
    load_jax_params(tm, _np(jp))
    if build != "init_discriminator":
        jp, tm = jp["discriminator"], tm.discriminator
    assert tuple(tm.out.w.shape) == (4 * 15 * 64, 1)   # cfg: 3 * 15 * 64
    specs = np.abs(np.random.default_rng(40).standard_normal(
        (2, 2, 40, cfg_t.freq_bins))).astype(np.float32)
    ref = jax_discriminator(jp, jnp.asarray(specs), cfg_j)
    with torch.no_grad():
        ours = apply_discriminator(tm, _t(specs), cfg_t)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("seconds", [0.5, 0.36])
def test_apply_discriminator_matches_jax(seconds):
    """A T != F shape (T = 32 and 23 frames against F = 129 bins) with 64
    channels into the flatten: the port must flatten in NHWC order to use
    `out.w` as JAX lays it out (an NCHW flatten runs but scores
    differently)."""
    over = dict(use_discriminator=True, max_len_seconds=seconds)
    cfg_j = jax_preset("synth_tiny").replace(**over)
    cfg_t = preset("synth_tiny").replace(**over)
    t = cfg_t.num_frames
    assert t == cfg_j.num_frames and t in (32, 23)
    jp = jax_init_discriminator(jax.random.PRNGKey(2), cfg_j)
    tp = load_jax_params(init_discriminator(cfg_t, device="cpu"), _np(jp))
    assert tuple(tp.out.w.shape) == np.asarray(jp["out"]["w"]).shape
    specs = np.abs(np.random.default_rng(t).standard_normal(
        (2, 2, t, cfg_t.freq_bins))).astype(np.float32)
    ref = jax_discriminator(jp, jnp.asarray(specs), cfg_j)
    with torch.no_grad():
        ours = apply_discriminator(tp, _t(specs), cfg_t)
    assert tuple(ours.shape) == (4, 1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
    # the logit, before the sigmoid flattens the difference
    with torch.no_grad():
        x = _t(specs).reshape(4, t, cfg_t.freq_bins, 1)
        from dl4ss_tpu_torch.models.common import conv2d
        for conv in (tp.conv0, tp.conv1, tp.conv2):
            x = torch.relu(conv2d(conv, x, stride=(2, 2)))
        nchw = x.permute(0, 3, 1, 2).reshape(4, -1) @ tp.out.w + tp.out.b
        nhwc = x.reshape(4, -1) @ tp.out.w + tp.out.b
    assert not torch.allclose(nchw, nhwc, atol=1e-3)
    np.testing.assert_allclose(torch.sigmoid(nhwc).numpy(), np.asarray(ref),
                               atol=1e-5)


@pytest.mark.parametrize("head", ["dot", "align"])
def test_crm_heads_match_jax(head):
    over = dict(is_complex_mask=True, mask_head=head, embedding_size=6)
    cfg_j = jax_preset("synth_tiny").replace(**over)
    cfg_t = preset("synth_tiny").replace(**over)
    jp = jax_init_head(jax.random.PRNGKey(0), cfg_j)
    tp = load_jax_params(init_mask_head(cfg_t, device="cpu"), _np(jp))
    rng = np.random.default_rng(3)
    emb = np.tanh(rng.standard_normal((2, 5, 7, 6))).astype(np.float32)
    q = rng.standard_normal((2, 2, 12)).astype(np.float32)
    ref = jax_mask_head(jp, jnp.asarray(emb), jnp.asarray(q), cfg_j)
    with torch.no_grad():
        ours = apply_mask_head(tp, _t(emb), _t(q), cfg_t)
    assert tuple(ours.shape) == (2, 2, 5, 7, 2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def _pair(**overrides):
    cfg_j = jax_preset("synth_tiny").replace(**overrides)
    cfg_t = preset("synth_tiny").replace(**overrides)
    params = jax_init_separator(jax.random.PRNGKey(0), cfg_j)
    model = load_jax_params(Separator(cfg_t, device="cpu"), _np(params))
    return cfg_j, params, cfg_t, model


def _inputs(seed, t=12):
    rng = np.random.default_rng(seed)
    feat = np.abs(rng.standard_normal((3, t, 129))).astype(np.float32)
    ri = rng.standard_normal((3, t, 129, 2)).astype(np.float32)
    return feat, ri


@pytest.mark.parametrize("over", [TDAA, CRM, dict(TDAA, **KERNELS)],
                         ids=["tdaa", "tdaa_crm", "tdaa_kernels"])
def test_separate_with_adjust_matches_jax(over):
    """`separate` with given and with classifier-selected speakers: the
    ADDJUST queries and the masks and predictions, at 1e-4 (f32 both
    sides; with the kernel flags on both run the bf16 mask head at the
    same rounding points, where one flipped bf16 rounding moves a mask by
    < 7.5e-3, test_torch_models.py::test_separate_matches_jax: 1e-2)."""
    cfg_j, params, cfg_t, model = _pair(**over)
    feat, ri = _inputs(4)
    spk = np.array([[0, 1], [2, 3], [7, 4]])
    tol = 1e-2 if over.get("use_pallas_maskhead") else 1e-4
    for idx in (spk, None):
        ref = jax_separate(params, jnp.asarray(feat), cfg_j,
                           spk_idx=None if idx is None else jnp.asarray(idx),
                           mix_ri=jnp.asarray(ri))
        with torch.no_grad():
            ours = separate(model, _t(feat), cfg_t,
                            spk_idx=None if idx is None else _t(idx),
                            mix_ri=_t(ri))
        np.testing.assert_allclose(ours.queries.numpy(),
                                   np.asarray(ref.queries), atol=1e-4)
        for a, b in ((ours.masks, ref.masks), (ours.pred, ref.pred)):
            scale = max(1.0, float(np.abs(np.asarray(b)).max()))
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=tol * scale)


@pytest.mark.parametrize("over", [TDAA, CRM], ids=["tdaa", "tdaa_crm"])
def test_separate_dense_matches_jax(over):
    cfg_j, params, cfg_t, model = _pair(**over)
    feat, ri = _inputs(5)
    gate = np.zeros((3, cfg_t.num_speakers), np.float32)
    gate[0, [1, 2]] = gate[1, [0, 5]] = gate[2, [3]] = 1.0
    ref = jax_dense(params, jnp.asarray(feat), cfg_j, jnp.asarray(gate),
                    mix_ri=jnp.asarray(ri))
    with torch.no_grad():
        ours = separate_dense(model, _t(feat), cfg_t, _t(gate),
                              mix_ri=_t(ri))
    assert ours.pred.shape == ref.pred.shape
    for a, b in ((ours.masks, ref.masks), (ours.pred, ref.pred),
                 (ours.queries, ref.queries)):
        scale = max(1.0, float(np.abs(np.asarray(b)).max()))
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=1e-4 * scale)
    assert not ours.masks[2, 0].any()        # a gated-off channel


def test_recursive_separate_with_adjust_matches_jax():
    cfg_j, params, cfg_t, model = _pair(recursive_max_steps=3,
                                        **dict(TDAA, use_discriminator=False))
    feat, _ = _inputs(6)
    ref_x, ref_s = jax_recursive(params, jnp.asarray(feat), cfg_j)
    with torch.no_grad():
        ours_x, ours_s = recursive_separate(model, _t(feat), cfg_t)
    np.testing.assert_array_equal(ours_s.numpy(), np.asarray(ref_s))
    np.testing.assert_allclose(ours_x.numpy(), np.asarray(ref_x), atol=1e-4)


def _setup(seed, **overrides):
    """Both configs, the JAX state, the port's state from the same
    params, one batch of features as numpy, and the JAX batch."""
    cfg_j = jax_preset("synth_tiny").replace(**overrides)
    cfg_t = preset("synth_tiny").replace(**overrides)
    state_j = jax_state(jax.random.PRNGKey(seed), cfg_j)
    model = load_jax_params(Separator(cfg_t, device="cpu"),
                            _np(state_j.params))
    state_t = create_train_state(cfg_t, device="cpu", model=model)
    bank = jnp.asarray(jax_bank(seed, cfg_j.num_speakers, 3, cfg_j.max_len))
    batch = jax_sample(jax.random.PRNGKey(seed + 1), bank, cfg_j)
    feats = {k: np.array(v) for k, v in jax_featurize(batch, cfg_j).items()}
    return cfg_j, state_j, cfg_t, state_t, feats, bank, batch


def _check_updates(state_j, new_j, new_t, update_tol):
    """Every leaf's update (new - old) against JAX's; leaves JAX leaves
    unmoved stay unmoved. Returns the top-level subtrees that moved."""
    before = dict(flatten_tree(_np(state_j.params)))
    ref = dict(flatten_tree(_np(new_j.params)))
    ours = dict(flatten_tree(export_jax_params(new_t.model)))
    assert set(ours) == set(ref)
    moved = set()
    for name, value in ref.items():
        want, got = value - before[name], ours[name] - before[name]
        if not np.any(want):
            assert not np.any(got), name
            continue
        moved.add(name.split(".")[0])
        assert _rel(got, want) < update_tol, (name, _rel(got, want))
    return moved


def _jnp(feats):
    return {k: jnp.asarray(v) for k, v in feats.items()}


def _torch(feats):
    return {k: torch.as_tensor(v) for k, v in feats.items()}


@pytest.mark.parametrize("over", [dict(TDAA, use_discriminator=False), CRM],
                         ids=["magnitude", "crm"])
def test_dense_step_matches_jax(over):
    """One `make_dense_train_step` from the same params and feats: 1e-5 on
    the loss, 1e-3 relative L2 on each update (Adam's first step divides
    g by |g| + 1e-8 and so amplifies f32 round-off on the smallest
    gradients)."""
    cfg_j, state_j, cfg_t, state_t, feats, _, _ = _setup(8, **over)
    new_j, met_j = jax_dense_step(cfg_j)(state_j, _jnp(feats))
    new_t, met_t = make_dense_train_step(cfg_t)(state_t, _torch(feats))
    assert new_t.step == 1
    for key in ("loss", "mask_loss"):
        assert abs(float(met_t[key]) - float(met_j[key])) \
            <= 1e-5 * abs(float(met_j[key])), key
    assert "adjust" in _check_updates(state_j, new_j, new_t, 1e-3)


@pytest.mark.parametrize("with_real", [False, True],
                         ids=["dis_ss", "dis_sp"])
def test_adversarial_step_matches_jax(with_real):
    """One `make_adversarial_step`, with the clean targets (dis-ss) and with
    given real spectra (dis-sp): both losses and both phases' updates.
    Phase 1 moves the discriminator alone, phase 2 the generator's
    parameters alone, so every discriminator leaf moves exactly as JAX's
    (once) and the generator's as JAX's."""
    cfg_j, state_j, cfg_t, state_t, feats, _, _ = _setup(9, **TDAA)
    if with_real:
        feats = dict(feats, real_specs=np.abs(np.random.default_rng(9)
                                              .standard_normal(
                                                  feats["src_feas"].shape))
                     .astype(np.float32))
    new_j, met_j = jax_adv_step(cfg_j)(state_j, _jnp(feats))
    new_t, met_t = make_adversarial_step(cfg_t)(state_t, _torch(feats))
    assert new_t.step == 1 and new_t.d_opt_state.count == 1
    for key in ("d_loss", "g_loss", "mask_loss", "sum_loss"):
        assert abs(float(met_t[key]) - float(met_j[key])) \
            <= 1e-5 * abs(float(met_j[key])), key
    for key in ("d_acc_real", "d_acc_fake"):
        assert float(met_t[key]) == float(met_j[key]), key
    moved = _check_updates(state_j, new_j, new_t, 1e-3)
    assert {"discriminator", "adjust", "encoder"} <= moved


def test_adversarial_step_kernel_route_matches_jax():
    """The tdaa preset's route: the kernel flags on both sides (K1, K3/K6
    and K7/K8's plain versions here, the Pallas kernels in interpret mode
    in JAX). Both run the bf16 mask head at the same rounding points: the
    repo's bars for bf16 kernels and their gradients, 2e-2 on the losses
    and 5e-2 on each update."""
    cfg_j, state_j, cfg_t, state_t, feats, _, _ = _setup(
        10, **TDAA, **KERNELS)
    new_j, met_j = jax_adv_step(cfg_j)(state_j, _jnp(feats))
    new_t, met_t = make_adversarial_step(cfg_t)(state_t, _torch(feats))
    for key in ("d_loss", "g_loss", "mask_loss"):
        assert abs(float(met_t[key]) - float(met_j[key])) \
            <= 2e-2 * abs(float(met_j[key])), key
    _check_updates(state_j, new_j, new_t, 5e-2)


def test_crm_train_and_eval_steps_match_jax():
    """The cRM eval step, which resynthesises the predicted complex
    spectra (1e-4 dB on the SI-SDR), and the cRM joint step (complex MSE
    under PIT): 1e-5 on the loss, and every gradient leaf at 1e-5 relative
    L2. Here the updates are held at 1e-2: the uncompressed cRM spreads the
    gradients over nine decades, and where |g| is near Adam's eps (1e-8)
    its first step maps an f32 round-off of the gradient, amplified by up to
    1/eps, onto the update."""
    from dl4ss_tpu.train.steps import _gen_params
    from dl4ss_tpu.train.steps import _separation_loss as jax_loss
    from dl4ss_tpu_torch.train.steps import _separation_loss
    cfg_j, state_j, cfg_t, state_t, feats, _, _ = _setup(11, **CRM)
    ref_ev = jax_eval_step(cfg_j)(state_j.params, _jnp(feats))
    ours_ev = make_eval_step(cfg_t)(state_t.model, _torch(feats))
    np.testing.assert_allclose(ours_ev["si_sdr"].numpy(),
                               np.asarray(ref_ev["si_sdr"]), atol=1e-4)
    ref_g = dict(flatten_tree(_np(jax.grad(lambda gp: jax_loss(
        dict(state_j.params, **gp), _jnp(feats), cfg_j)[0])(
            _gen_params(state_j.params)))))
    params = dict(state_t.model.named_parameters())
    grads = torch.autograd.grad(
        _separation_loss(state_t.model, _torch(feats), cfg_t)[0],
        list(params.values()), allow_unused=True)
    for name, g in zip(params, grads):
        if not np.any(ref_g[name]):
            assert g is None or not bool(g.any()), name
            continue
        assert _rel(g.numpy(), ref_g[name]) < 1e-5, name
    new_j, met_j = jax_train_step(cfg_j)(state_j, _jnp(feats))
    new_t, met_t = make_train_step(cfg_t)(state_t, _torch(feats))
    assert abs(float(met_t["loss"]) - float(met_j["loss"])) \
        <= 1e-5 * abs(float(met_j["loss"]))
    _check_updates(state_j, new_j, new_t, 1e-2)


def test_crm_si_sdr_loss_matches_jax():
    """loss_mode='si_sdr' on a cRM model resynthesises istft(unpack_ri(pred))
    inside the loss."""
    cfg_j, state_j, cfg_t, state_t, feats, _, _ = _setup(
        12, loss_mode="si_sdr", **CRM)
    _, met_j = jax_train_step(cfg_j)(state_j, _jnp(feats))
    _, met_t = make_train_step(cfg_t)(state_t, _torch(feats))
    assert abs(float(met_t["loss"]) - float(met_j["loss"])) \
        <= 1e-4 * abs(float(met_j["loss"]))


def test_same_speaker_real_specs_matches_jax():
    """The dis-sp real pool from the same bank, batch and utterance
    offsets (drawn as JAX draws them): the same spectra at 1e-4, never the
    mixed utterance itself."""
    cfg_j, _, cfg_t, _, _, bank, batch = _setup(13, **TDAA)
    key = jax.random.PRNGKey(5)
    b, k = batch.spk_idx.shape
    offsets = np.asarray(jax.random.randint(key, (b, k), 1, bank.shape[1]))
    ref = jax_real_specs(key, batch, bank, cfg_j)
    tb = MixtureBatch(*(None if x is None else _t(x) for x in batch))
    ours = same_speaker_real_specs(torch.Generator().manual_seed(0), tb,
                                   _t(bank), cfg_t, offsets=_t(offsets))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)
    # drawn offsets lie in [1, U-1]: the mixed utterance is never drawn
    drawn = same_speaker_real_specs(torch.Generator().manual_seed(0), tb,
                                    _t(bank), cfg_t)
    off = torch.randint(1, bank.shape[1], (b, k),
                        generator=torch.Generator().manual_seed(0))
    assert bool((off >= 1).all())
    torch.testing.assert_close(drawn, same_speaker_real_specs(
        None, tb, _t(bank), cfg_t, offsets=off), rtol=0, atol=0)


@pytest.mark.parametrize("kernel_route", [False, True])
def test_remat_gives_the_same_values_and_gradients(kernel_route):
    """cfg.remat recomputes each recurrent layer in the backward
    (torch.utils.checkpoint, JAX's jax.checkpoint): the loss and every
    gradient equal remat=False's bit for bit on the CPU, on the plain and
    the kernel routes, for the encoder and the classifier."""
    cfg = preset("synth_tiny").replace(encoder_rnn="lstm", is_self_tune=True,
                                       use_pallas_rnn=kernel_route)
    feat = torch.as_tensor(_inputs(14)[0])
    spk = torch.tensor([[0, 1], [2, 3], [4, 5]])
    results = []
    for remat in (False, True):
        model = load_jax_params(
            Separator(cfg, device="cpu"),
            _np(jax_init_separator(jax.random.PRNGKey(3),
                                   jax_preset("synth_tiny").replace(
                                       encoder_rnn="lstm",
                                       is_self_tune=True))))
        c = cfg.replace(remat=remat)
        out = separate(model, feat, c, spk_idx=spk, need_probs=True)
        loss = out.pred.square().mean() + out.probs.square().mean()
        loss.backward()
        results.append((loss.detach(),
                        {n: p.grad.clone() for n, p in
                         model.named_parameters() if p.grad is not None}))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert set(g0) == set(g1) and any(n.startswith("classifier") for n in g0)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
