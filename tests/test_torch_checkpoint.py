"""The port's checkpoints (`train/checkpoint.py`) and the CLIs that use
them, on the CPU at synth_tiny: exact resume, the `cfg.json` sidecar
against the JAX package's, the refusals of mismatched donors, and
run.train -> run.separate -> run.evaluate end to end."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from dl4ss_tpu import preset as jax_preset
from dl4ss_tpu.train.checkpoint import save_checkpoint as jax_save
from dl4ss_tpu.train.state import create_train_state as jax_state
from dl4ss_tpu_torch import preset
from dl4ss_tpu_torch.data.synth import make_synthetic_bank
from dl4ss_tpu_torch.train.checkpoint import (MAX_TO_KEEP, init_params_from,
                                              latest_step, load_cfg,
                                              load_components,
                                              restore_checkpoint,
                                              save_checkpoint)
from dl4ss_tpu_torch.train.loop import train_loop
from dl4ss_tpu_torch.train.state import create_train_state
from dl4ss_tpu_torch.train.steps import (make_adversarial_step,
                                         make_fused_step)


def _bank(cfg):
    return torch.as_tensor(make_synthetic_bank(0, cfg.num_speakers, 2,
                                               cfg.max_len))


def _same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for x, y in ((a.opt_state, b.opt_state), (a.d_opt_state, b.d_opt_state)):
        if x is None:
            assert y is None
            continue
        assert x.count == y.count
        for u, v in zip(x.mu + x.nu, y.mu + y.nu):
            assert torch.equal(u, v)
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("preset_name,over", [
    ("synth_tiny", {}),
    ("synth_tiny", dict(encoder_rnn="lstm", is_self_tune=True,
                        use_discriminator=True)),
], ids=["joint", "adversarial"])
def test_resume_equals_the_unbroken_run(tmp_path, preset_name, over):
    """Three steps unbroken against two steps, a save, a restore into a
    fresh state and one more step: the same parameters, moments, step and
    batch generator, bit for bit (the generator state in the file makes
    the resumed run draw the same batch). The adversarial case carries the
    discriminator's optimizer state too."""
    cfg = preset(preset_name).replace(**over)
    bank = _bank(cfg)
    if cfg.use_discriminator:
        inner = make_adversarial_step(cfg)
        from dl4ss_tpu_torch.data.synth import featurize, sample_mixtures

        def step(state, bank_):
            return inner(state, featurize(
                sample_mixtures(state.generator, bank_, cfg), cfg))
    else:
        step = make_fused_step(cfg)
    unbroken = create_train_state(cfg, seed=3, device="cpu")
    for _ in range(3):
        unbroken, _ = step(unbroken, bank)
    broken = create_train_state(cfg, seed=3, device="cpu")
    for _ in range(2):
        broken, _ = step(broken, bank)
    save_checkpoint(str(tmp_path), broken, cfg=cfg)
    resumed = restore_checkpoint(
        str(tmp_path), create_train_state(cfg, seed=99, device="cpu"))
    assert resumed.step == 2
    resumed, _ = step(resumed, bank)
    _same_state(resumed, unbroken)


def test_checkpoint_files_are_whole_and_few(tmp_path):
    """One file per step, loadable with weights_only=True, no temporary
    file left behind, the last MAX_TO_KEEP steps kept."""
    cfg = preset("synth_tiny")
    state = create_train_state(cfg, device="cpu")
    for step in range(MAX_TO_KEEP + 2):
        save_checkpoint(str(tmp_path), state, step=step)
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(f"step_{s}.pt" for s in range(2, MAX_TO_KEEP + 2))
    assert latest_step(str(tmp_path)) == MAX_TO_KEEP + 1
    payload = torch.load(tmp_path / names[0], weights_only=True)
    assert set(payload) == {"step", "model", "opt_state", "d_opt_state",
                            "generator"}
    assert latest_step(str(tmp_path / "absent")) is None


def test_cfg_sidecar_is_byte_equal_to_the_jax_one(tmp_path):
    """The same Config written by the JAX save_checkpoint and by the port's
    gives the same cfg.json, byte for byte, and each package reads the
    other's."""
    over = dict(encoder_rnn="lstm", is_self_tune=True, batch_size=3)
    cfg_j = jax_preset("tdaa").replace(**over)
    cfg_t = preset("tdaa").replace(**over)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    state_j = jax_state(jax.random.PRNGKey(0),
                        jax_preset("synth_tiny"))
    jax_save(str(jdir), state_j, cfg=cfg_j)
    save_checkpoint(str(tdir), create_train_state(
        preset("synth_tiny"), device="cpu"), cfg=cfg_t)
    assert (jdir / "cfg.json").read_bytes() == (tdir / "cfg.json").read_bytes()
    assert load_cfg(str(jdir)) == cfg_t


def test_load_cfg_drops_unknown_keys(tmp_path):
    raw = json.loads(preset("synth_tiny").to_json())
    raw["a_key_no_config_has"] = 7
    (tmp_path / "cfg.json").write_text(json.dumps(raw))
    assert load_cfg(str(tmp_path)) == preset("synth_tiny")
    assert load_cfg(str(tmp_path / "none")) is None


def _donor(tmp_path, name, cfg):
    directory = str(tmp_path / name)
    save_checkpoint(directory, create_train_state(cfg, seed=5, device="cpu"),
                    cfg=cfg)
    return directory


def test_init_params_from_and_load_components(tmp_path):
    """A donor of the same shapes is copied in (the whole model, or one
    component); a donor whose shapes differ is refused before anything is
    written, naming the donor and both presets."""
    cfg = preset("synth_tiny")
    donor = _donor(tmp_path, "same", cfg)
    state = create_train_state(cfg, seed=1, device="cpu")
    init_params_from(state, donor, cfg=cfg)
    ref = create_train_state(cfg, seed=5, device="cpu").model
    for (n, a), b in zip(state.model.named_parameters(), ref.parameters()):
        assert torch.equal(a, b), n
    assert state.opt_state.count == 0

    wide = _donor(tmp_path, "wide", cfg.replace(name="wide",
                                                hidden_units=48))
    state = create_train_state(cfg, seed=1, device="cpu")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    with pytest.raises(ValueError, match=r"'wide'.*preset 'synth_tiny'"):
        init_params_from(state, wide, cfg=cfg)
    # the classifier fits, the encoder does not: nothing is written
    with pytest.raises(ValueError, match="component 'encoder'"):
        load_components(state, {"classifier": donor, "encoder": wide},
                        cfg=cfg)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with pytest.raises(KeyError, match="no component 'adjust'"):
        load_components(state, {"adjust": donor}, cfg=cfg)
    load_components(state, {"classifier": donor}, cfg=cfg)
    assert torch.equal(state.model.classifier.out.w, ref.classifier.out.w)
    assert torch.equal(state.model.encoder.proj.w,
                       before["encoder.proj.w"])


def test_cross_preset_init_from_exits_with_one_line(tmp_path):
    """A tdaa-shaped donor (LSTM encoder, ADDJUST, discriminator) into a
    torch_multi-family run exits with one line naming both presets, where
    the JAX CLI crashes inside orbax."""
    from dl4ss_tpu_torch.run import train as cli
    tdaa_tiny = preset("synth_tiny").replace(
        name="tdaa", encoder_rnn="lstm", is_self_tune=True,
        use_discriminator=True)
    donor = _donor(tmp_path, "tdaa", tdaa_tiny)
    with pytest.raises(SystemExit) as exc:
        cli.main(["--preset", "synth_tiny", "--device", "cpu", "--epochs",
                  "1", "--epoch-size", "1", "--init-from", donor])
    message = str(exc.value)
    assert "\n" not in message
    assert "'tdaa'" in message and "'synth_tiny'" in message


def test_train_loop_saves_and_resumes(tmp_path):
    """train_loop with a checkpoint dir: 2 epochs, then --resume to 3,
    equals 3 unbroken epochs (the per-epoch eval draws from the same
    generator on both runs); the sidecar records the training config."""
    cfg = preset("synth_tiny")
    bank = _bank(cfg)
    ck = str(tmp_path / "ck")
    kw = dict(bank=bank, epoch_size=2, seed=4, device="cpu")
    train_loop(cfg, max_epochs=2, checkpoint_dir=ck, **kw)
    assert latest_step(ck) == 4 and load_cfg(ck).name == "synth_tiny"
    resumed, sdr_r = train_loop(cfg, max_epochs=3, checkpoint_dir=ck,
                                resume=True, **kw)
    unbroken, sdr_u = train_loop(cfg, max_epochs=3, **kw)
    assert latest_step(ck) == 6 and len(sdr_r) == 1
    assert sdr_r[-1] == sdr_u[-1]
    # the eval's draw leaves the two generators at the same point
    _same_state(resumed, unbroken)


def test_cli_train_then_separate_then_evaluate(tmp_path, capsys):
    """run.train --checkpoint-dir, run.separate --checkpoint-dir (the
    trained weights, not --seed's) and run.evaluate (teacher-forced,
    top-k and recursive) end to end on synth_tiny."""
    from dl4ss_tpu_torch.data.wavio import write_wav
    from dl4ss_tpu_torch.run import evaluate, separate, train
    ck = str(tmp_path / "ck")
    state = train.main(["--preset", "synth_tiny", "--device", "cpu",
                        "--epochs", "1", "--epoch-size", "2", "--utts", "2",
                        "--checkpoint-dir", ck])
    assert latest_step(ck) == 2
    wav = str(tmp_path / "mix.wav")
    write_wav(wav, np.random.default_rng(0).uniform(-0.5, 0.5, 3000), 8000)
    outs = {}
    for name, extra in (("trained", ["--checkpoint-dir", ck]),
                        ("seeded", [])):
        out = tmp_path / name
        separate.main([wav, "--preset", "synth_tiny", "--device", "cpu",
                       "--speakers", "0,1", "--out", str(out), *extra])
        outs[name] = sorted(os.listdir(out))
        assert len(outs[name]) == 2
    from dl4ss_tpu_torch.data.wavio import read_wav
    a = read_wav(str(tmp_path / "trained" / outs["trained"][0]))[0]
    b = read_wav(str(tmp_path / "seeded" / outs["seeded"][0]))[0]
    assert not np.allclose(a, b)
    capsys.readouterr()
    scores = [evaluate.main(["--checkpoint-dir", ck, "--device", "cpu",
                             "--batches", "2", *extra])
              for extra in (["--teacher-forced"], [],
                            ["--mode", "recursive", "--candidates", "4"])]
    printed = capsys.readouterr().out
    assert np.isfinite(scores).all()
    assert printed.count("SI-SDR over 2 batches") == 3
    assert "restored step 2" in printed and "speaker hit rate" in printed
    assert state.step == 2


def test_classify_cli_eval_only(tmp_path, capsys):
    """run.classify --checkpoint-dir saves the classifier it trains;
    --eval-only restores it and reports the same metric suite."""
    from dl4ss_tpu_torch.run import classify
    ck = str(tmp_path / "ck")
    args = ["--preset", "synth_tiny", "--device", "cpu", "--eval-batches",
            "1", "--utts", "2", "--checkpoint-dir", ck]
    trained = classify.main([*args, "--epochs", "1", "--epoch-size", "2"])
    restored = classify.main([*args, "--eval-only"])
    assert trained == restored
    assert "restored step 2" in capsys.readouterr().out
