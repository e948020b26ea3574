"""Training and scoring from the port's data sources, against the JAX
package on the CPU: the list-driven joint step, the tdaa adversarial step
with the list's dis-sp real pool, the street-noise add and the fused step
with a noise bank, then the CLIs end to end on a rehearsal corpus written
here (0.25 s utterances, synth_tiny widths): run.train --list-dir (with
vocab.json and --resume), run.evaluate --list-dir --bss-eval --oracle
--export-wavs, run.score, run.classify --list-dir, run.train --data-root
--noise-wavs with the per-epoch wav export, and run.analyze."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl4ss_tpu import preset as jax_preset
from dl4ss_tpu.data import listsampler as jax_lists
from dl4ss_tpu.data.synth import add_noise_to_mix as jax_add_noise
from dl4ss_tpu.data.synth import featurize as jax_featurize
from dl4ss_tpu.run.analyze import pca2 as jax_pca2
from dl4ss_tpu.train.state import create_train_state as jax_state
from dl4ss_tpu.train.steps import _gen_params
from dl4ss_tpu.train.steps import _separation_loss as jax_loss
from dl4ss_tpu.train.steps import make_adversarial_step as jax_adv_step
from dl4ss_tpu_torch import preset
from dl4ss_tpu_torch.data import listsampler
from dl4ss_tpu_torch.data.rehearsal import generate_corpus
from dl4ss_tpu_torch.data.synth import (MixtureBatch, add_noise_to_mix,
                                        featurize, make_synthetic_bank,
                                        sample_mixtures)
from dl4ss_tpu_torch.data.wavio import write_wav
from dl4ss_tpu_torch.models import Separator
from dl4ss_tpu_torch.train.state import create_train_state
from dl4ss_tpu_torch.train.steps import (_separation_loss,
                                         make_adversarial_step,
                                         make_fused_step, make_train_step)
from dl4ss_tpu_torch.weights import flatten_tree, load_jax_params

SECONDS = 0.25
TDAA = dict(encoder_rnn="lstm", is_self_tune=True, use_discriminator=True)
CPU = ["--preset", "synth_tiny", "--device", "cpu", "--set",
       f"max_len_seconds={SECONDS}", "--set", "batch_size_eval=4"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """5 speakers x 4 utterances; k = 1, 2, 3 lists of 9 tr / 8 cv / 8 tt
    entries."""
    root = tmp_path_factory.mktemp("corpus")
    generate_corpus(str(root), n_spk=5, utts=4, seconds=SECONDS,
                    tr_entries=9, cv_entries=8, tt_entries=8,
                    mix_ks=(1, 2, 3), cv_holdout=1)
    return str(root)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _list_setup(corpus, seed, **over):
    """Both configs (the lists' 5 speakers), the JAX state, the port's
    state from the same params, both samplers, and the first list batch of
    an epoch as features on both sides."""
    over = dict(max_len_seconds=SECONDS, num_speakers=5, **over)
    cfg_j = jax_preset("synth_tiny").replace(**over)
    cfg_t = preset("synth_tiny").replace(**over)
    lists = os.path.join(corpus, "lists")
    ours = listsampler.Wsj0MixSampler(lists, corpus, cfg_t, mix_ks=(2, 3),
                                      device="cpu")
    ref = jax_lists.Wsj0MixSampler(lists, corpus, cfg_j, mix_ks=(2, 3))
    state_j = jax_state(jax.random.PRNGKey(seed), cfg_j)
    model = load_jax_params(Separator(cfg_t, device="cpu"),
                            _np(state_j.params))
    state_t = create_train_state(cfg_t, device="cpu", model=model)
    utt, db, spk, live = next(ref.epoch(4, seed=seed))
    batch_j = jax_lists.mix_from_list(
        jnp.asarray(ref.bank), jnp.asarray(utt), jnp.asarray(db),
        jnp.asarray(spk), cfg_j, live=jnp.asarray(live))
    batch_t = ours.to_batch(utt, db, spk, live)
    feats_j = {k: np.array(v) for k, v in
               jax_featurize(batch_j, cfg_j).items()}
    feats_t = featurize(batch_t, cfg_t)
    for key in ("mix_feas", "src_feas", "mix_ri"):
        np.testing.assert_allclose(feats_t[key].numpy(), feats_j[key],
                                   atol=1e-4)
    return (cfg_j, cfg_t, state_j, state_t, ours, ref, batch_j, batch_t,
            feats_j, (utt, db, spk, live))


def test_list_driven_joint_step_matches_jax(corpus):
    """One list batch of the k=2 / k=3 pools (a padded dead channel in
    the k=2 entries): features within 1e-4, the joint loss within 1e-5
    (relative) and every gradient leaf within 1e-3 relative L2 of JAX's,
    and a step of make_train_step moves every generator leaf JAX moves."""
    (cfg_j, cfg_t, state_j, state_t, _, _, _, _, feats_j,
     _) = _list_setup(corpus, 1)
    jfeats = {k: jnp.asarray(v) for k, v in feats_j.items()}
    tfeats = {k: torch.as_tensor(v) for k, v in feats_j.items()}
    (loss_j, _), grads_j = jax.value_and_grad(
        lambda gp: jax_loss(dict(state_j.params, **gp), jfeats, cfg_j),
        has_aux=True)(_gen_params(state_j.params))
    params = dict(state_t.model.named_parameters())
    loss_t = _separation_loss(state_t.model, tfeats, cfg_t)[0]
    assert abs(float(loss_t.detach()) - float(loss_j)) \
        <= 1e-5 * abs(float(loss_j))
    ref_g = dict(flatten_tree(_np(grads_j)))
    grads = torch.autograd.grad(loss_t, list(params.values()),
                                allow_unused=True)
    for name, g in zip(params, grads):
        if name not in ref_g:
            continue
        if not np.any(ref_g[name]):
            assert g is None or not g.any(), name
            continue
        assert _rel(g.numpy(), ref_g[name]) < 1e-3, name
    before = {n: p.detach().clone() for n, p in params.items()}
    new_t, met = make_train_step(cfg_t)(state_t, tfeats)
    assert new_t.step == 1 and np.isfinite(float(met["loss"]))
    moved = {n for n, p in new_t.model.named_parameters()
             if not torch.equal(p, before[n])}
    assert moved == {n for n in ref_g if np.any(ref_g[n])}


def _leaf_grads_match(ref_tree, names, grads, tol):
    ref_g = dict(flatten_tree(_np(ref_tree)))
    checked = 0
    for name, g in zip(names, grads):
        want = ref_g[name]
        if not np.any(want):
            assert g is None or not g.any(), name
            continue
        assert _rel(g.numpy(), want) < tol, (name, _rel(g.numpy(), want))
        checked += 1
    return checked


def test_list_dis_sp_adversarial_step_matches_jax(corpus):
    """TDAA's adversarial step on a list batch with the dis-sp real pool
    from the list vocabulary (JAX's draws r given to the port): the real
    spectra within 1e-4; the step's losses within 1e-5 of JAX's; each
    phase's gradients within 1e-3 relative L2, leaf by leaf: the
    discriminator's from the same params, the generator's against the
    discriminator JAX's phase 1 left."""
    from dl4ss_tpu.models.discriminator import (
        apply_discriminator as jax_disc)
    from dl4ss_tpu.models.separator import separate as jax_separate
    from dl4ss_tpu.objectives.losses import gan_d_loss as jax_d_loss
    from dl4ss_tpu.objectives.losses import gan_g_loss as jax_g_loss
    from dl4ss_tpu.objectives.losses import sum_to_one_loss as jax_sum_loss
    from dl4ss_tpu_torch.models.discriminator import apply_discriminator
    from dl4ss_tpu_torch.objectives.losses import (gan_d_loss, gan_g_loss,
                                                   sum_to_one_loss)
    (cfg_j, cfg_t, state_j, state_t, ours, ref, batch_j, batch_t, feats_j,
     arrays) = _list_setup(corpus, 2, **TDAA)
    key = jax.random.PRNGKey(5)
    real_j = np.asarray(jax_lists.list_same_speaker_real_specs(
        key, batch_j, jnp.asarray(ref.bank), jnp.asarray(ref.spk_rows),
        jnp.asarray(ref.spk_counts), cfg_j))
    r = torch.as_tensor(np.array(jax.random.randint(
        key, arrays[2].shape, 0, 1 << 30))).long()
    rows_t, counts_t = ours.spk_tables()
    real_t = listsampler.list_same_speaker_real_specs(
        None, batch_t, ours.device_bank(), rows_t, counts_t, cfg_t, r=r)
    np.testing.assert_allclose(real_t.numpy(), real_j, atol=1e-4)
    feats = dict(feats_j, real_specs=real_j)
    jf = {k: jnp.asarray(v) for k, v in feats.items()}
    tf = {k: torch.as_tensor(np.array(v)) for k, v in feats.items()}
    live_j = jf["channel_live"].astype(jnp.float32)
    live_t = tf["channel_live"].float()

    # phase 1: the discriminator's gradient
    fake_j = jax.lax.stop_gradient(jax_separate(
        state_j.params, jf["mix_feas"], cfg_j, spk_idx=jf["spk_idx"]).pred
        * live_j[..., None, None])
    d_grads_j = jax.grad(lambda dp: jax_d_loss(
        jax_disc(dp, jf["real_specs"], cfg_j), jax_disc(dp, fake_j, cfg_j)))(
            state_j.params["discriminator"])
    model = state_t.model
    with torch.no_grad():
        fake_t = _separation_loss(model, tf, cfg_t)[1]["out"].pred \
            * live_t[..., None, None]
    d_names = [n for n, _ in model.discriminator.named_parameters()]
    d_loss_t = gan_d_loss(apply_discriminator(model.discriminator,
                                              tf["real_specs"], cfg_t),
                          apply_discriminator(model.discriminator, fake_t,
                                              cfg_t))
    d_grads = torch.autograd.grad(d_loss_t,
                                  list(model.discriminator.parameters()))
    assert _leaf_grads_match(d_grads_j, d_names, d_grads, 1e-3) > 0

    # one step of each: the losses
    new_j, met_j = jax_adv_step(cfg_j)(state_j, jf)
    new_t, met_t = make_adversarial_step(cfg_t)(
        create_train_state(cfg_t, device="cpu", model=load_jax_params(
            Separator(cfg_t, device="cpu"), _np(state_j.params))), tf)
    for k in ("d_loss", "g_loss", "mask_loss", "sum_loss"):
        assert abs(float(met_t[k]) - float(met_j[k])) \
            <= 1e-5 * abs(float(met_j[k])), k

    # phase 2: the generator's gradient against JAX's updated D
    params = dict(state_j.params,
                  discriminator=new_j.params["discriminator"])
    sep_j = cfg_j.replace(sum_loss_weight=0.0)

    def g_loss_j(gp):
        p = dict(params, **gp)
        mask_l, aux = jax_loss(p, jf, sep_j)
        pred = aux["out"].pred * live_j[..., None, None]
        return (mask_l + 0.5 * jax_sum_loss(aux["out"].masks
                                            * live_j[..., None, None])
                + jax_g_loss(jax_disc(p["discriminator"], pred, cfg_j)))
    g_grads_j = jax.grad(g_loss_j)(_gen_params(params))
    model = load_jax_params(Separator(cfg_t, device="cpu"), _np(params))
    mask_l, aux = _separation_loss(model, tf, cfg_t.replace(
        sum_loss_weight=0.0))
    pred = aux["out"].pred * live_t[..., None, None]
    total = (mask_l + 0.5 * sum_to_one_loss(aux["out"].masks
                                            * live_t[..., None, None])
             + gan_g_loss(apply_discriminator(model.discriminator, pred,
                                              cfg_t)))
    named = [(n, p) for n, p in model.named_parameters()
             if not n.startswith("discriminator.")]
    g_grads = torch.autograd.grad(total, [p for _, p in named],
                                  allow_unused=True)
    assert _leaf_grads_match(g_grads_j, [n for n, _ in named], g_grads,
                             1e-3) > 10


def test_street_noise_add_and_the_fused_step_with_a_noise_bank():
    """add_noise_to_mix adds 0.3 x a rolled noise row to the mixture only:
    equal to JAX's on a constant noise row (where the draws cannot differ),
    and on a random bank some row and shift explain the added noise. The
    fused step with a noise bank trains on the noisy batch that
    sample_mixtures draws from the same generator state."""
    cfg_j = jax_preset("synth_tiny").replace(max_len_seconds=SECONDS,
                                             add_bgd_noise=True)
    cfg_t = preset("synth_tiny").replace(max_len_seconds=SECONDS,
                                         add_bgd_noise=True)
    rng = np.random.default_rng(3)
    n = cfg_t.max_len
    src = rng.uniform(-0.5, 0.5, (3, 2, n)).astype(np.float32)
    spk = np.array([[0, 1], [2, 3], [4, 5]])
    gains = np.ones((3, 2), np.float32)
    const = np.full((1, n + 50), 0.25, np.float32)
    want = jax_add_noise(jax.random.PRNGKey(0), jax_lists.MixtureBatch(
        jnp.asarray(src.sum(1)), jnp.asarray(src), jnp.asarray(spk),
        jnp.asarray(gains)), jnp.asarray(const), cfg_j)
    batch = MixtureBatch(torch.as_tensor(src.sum(1)), torch.as_tensor(src),
                         torch.as_tensor(spk), torch.as_tensor(gains))
    gen = torch.Generator().manual_seed(0)
    got = add_noise_to_mix(gen, batch, torch.as_tensor(const), cfg_t)
    np.testing.assert_allclose(got.mix_wav.numpy(), np.asarray(want.mix_wav),
                               atol=1e-6)
    assert torch.equal(got.source_wavs, batch.source_wavs)
    noise = rng.standard_normal((4, n)).astype(np.float32)
    got = add_noise_to_mix(gen, batch, torch.as_tensor(noise), cfg_t)
    added = (got.mix_wav - batch.mix_wav).numpy()
    for row in added:
        assert any(np.allclose(row, 0.3 * np.roll(noise[i], s), atol=1e-6)
                   for i in range(4) for s in range(n))

    bank = torch.as_tensor(make_synthetic_bank(0, cfg_t.num_speakers, 2, n))
    nb = torch.as_tensor(noise)
    fused = create_train_state(cfg_t, seed=4, device="cpu")
    manual = create_train_state(cfg_t, seed=4, device="cpu")
    _, met_f = make_fused_step(cfg_t, noise_bank=nb)(fused, bank)
    b = sample_mixtures(manual.generator, bank, cfg_t, noise_bank=nb)
    assert not torch.allclose(b.mix_wav, b.source_wavs.sum(1))
    _, met_m = make_train_step(cfg_t)(manual, featurize(b, cfg_t))
    assert float(met_f["loss"]) == float(met_m["loss"])


def _sdr_line(text):
    line = next(x for x in text.splitlines() if x.startswith("BSS-Eval SDR"))
    return float(line.split()[2])


def test_list_cli_round_trip(tmp_path, corpus, capsys):
    """run.train --list-dir (2 steps an epoch from 9 tr entries at B=4,
    with the shift augment) writes vocab.json; 1 epoch + --resume equals 2
    unbroken epochs bit for bit; run.evaluate --list-dir --split test
    --bss-eval --oracle irm --export-wavs scores the checkpoint, and
    run.score on the export reproduces its SDR within 0.05 dB (the wavs are
    PCM16, and references with gains above 1 clip at full scale)."""
    from dl4ss_tpu_torch.run import evaluate, score, train
    lists = ["--list-dir", os.path.join(corpus, "lists"), "--wav-root",
             corpus, "--set", "augment_data=1"]
    ck, ck2 = str(tmp_path / "ck"), str(tmp_path / "ck2")
    train.main([*CPU, *lists, "--epochs", "1", "--checkpoint-dir", ck])
    with open(os.path.join(ck, "vocab.json")) as f:
        assert json.load(f) == {f"{i + 11:03d}": i for i in range(5)}
    resumed = train.main([*CPU, *lists, "--epochs", "2", "--checkpoint-dir",
                          ck, "--resume"])
    unbroken = train.main([*CPU, *lists, "--epochs", "2",
                           "--checkpoint-dir", ck2])
    assert resumed.step == unbroken.step == 4
    for a, b in zip(resumed.model.state_dict().values(),
                    unbroken.model.state_dict().values()):
        assert torch.equal(a, b)
    capsys.readouterr()
    out = str(tmp_path / "out")
    sisdr = evaluate.main([*CPU, "--checkpoint-dir", ck, "--list-dir",
                           os.path.join(corpus, "lists"), "--wav-root",
                           corpus, "--split", "test", "--teacher-forced",
                           "--bss-eval", "--oracle", "irm", "--export-wavs",
                           out])
    text = capsys.readouterr().out
    assert np.isfinite(sisdr) and "oracle IRM bound" in text
    assert "SI-SDR over 2 batches" in text        # the whole 8-entry split
    files = os.listdir(out)
    assert sum(f.endswith("_True_mix.wav") for f in files) == 8
    scored = score.main([out, "--nsdr", "--device", "cpu"])
    assert scored["n_mixtures"] == 8 and np.isfinite(scored["mean_nsdr"])
    assert abs(scored["mean_sdr"] - _sdr_line(text)) < 0.05


def test_classify_cli_on_the_lists(tmp_path, corpus, capsys):
    from dl4ss_tpu_torch.run import classify
    report = classify.main([*CPU, "--list-dir",
                            os.path.join(corpus, "lists"), "--wav-root",
                            corpus, "--mix-k", "1,2,3", "--epochs", "1",
                            "--eval-batches", "3", "--checkpoint-dir",
                            str(tmp_path / "ck")])
    assert 0.0 <= report["top3_recall"] <= 1.0
    assert "macro_f1:" in capsys.readouterr().out
    again = classify.main([*CPU, "--list-dir", os.path.join(corpus, "lists"),
                           "--wav-root", corpus, "--mix-k", "1,2,3",
                           "--eval-only", "--checkpoint-dir",
                           str(tmp_path / "ck"), "--eval-batches", "3"])
    assert again == report


def test_tree_noise_export_and_analyze_clis(tmp_path, corpus, capsys):
    """run.train --data-root --noise-wavs with the per-epoch wav export
    (cfg.out_sep_result), run.evaluate on the tree with noise, its refusal
    of data with more speakers than the checkpoint, and run.analyze's CSV
    (the PCA of the table, as JAX computes it)."""
    from dl4ss_tpu_torch.run import analyze, evaluate, train
    noise = tmp_path / "noise"
    noise.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        write_wav(noise / f"n{i}.wav", 0.3 * rng.standard_normal(3000), 8000)
    tree = ["--data-root", os.path.join(corpus, "wsj0"), "--split",
            "si_tr_s", "--utts", "3"]
    ck, wavs = str(tmp_path / "ck"), str(tmp_path / "epoch_wavs")
    state = train.main([*CPU, *tree, "--noise-wavs", str(noise), "--epochs",
                        "1", "--epoch-size", "2", "--checkpoint-dir", ck,
                        "--set", "out_sep_result=1", "--set",
                        f"output_dir={wavs}"])
    with open(os.path.join(ck, "cfg.json")) as f:
        saved = json.load(f)
    assert saved["num_speakers"] == 5 and saved["add_bgd_noise"]
    assert state.step == 2
    files = sorted(os.listdir(wavs))
    assert "0_True_mix.wav" in files and "3_True_mix.wav" in files
    assert sum(f.endswith("_genTrue.wav") for f in files) == 8
    capsys.readouterr()
    score = evaluate.main([*CPU, *tree, "--checkpoint-dir", ck,
                           "--noise-wavs", str(noise), "--batches", "1",
                           "--teacher-forced"])
    assert np.isfinite(score)
    with pytest.raises(SystemExit, match="references 8 speakers"):
        evaluate.main([*CPU, "--checkpoint-dir", ck, "--utts", "2",
                       "--set", "num_speakers=8"])
    coords = analyze.main([*CPU, "--checkpoint-dir", ck, "--out",
                           str(tmp_path / "emb")])
    table = state.model.embedding.table.detach().numpy()
    np.testing.assert_array_equal(coords, jax_pca2(table))
    lines = (tmp_path / "emb.csv").read_text().splitlines()
    assert lines[0] == "speaker,pc1,pc2" and len(lines) == 6
