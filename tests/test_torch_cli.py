"""The port's separation, classifier and training CLIs on the CPU
(`--device cpu`) at synth_tiny."""

import json

import numpy as np
import pytest
import torch

from dl4ss_tpu_torch.data.wavio import read_wav, write_wav
from dl4ss_tpu_torch.run import separate as cli


def _mixes(tmp_path, n=2, samples=3000, rate=8000):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        paths.append(str(tmp_path / f"mix{i}.wav"))
        write_wav(paths[-1], rng.uniform(-0.5, 0.5, samples), rate)
    return paths


def test_cli_writes_one_wav_per_speaker(tmp_path):
    paths = _mixes(tmp_path)
    out = tmp_path / "out"
    cli.main([*paths, "--preset", "synth_tiny", "--speakers", "0,1",
              "--out", str(out), "--device", "cpu"])
    wrote = sorted(p.name for p in out.iterdir())
    assert wrote == ["mix0_spk0_step0.wav", "mix0_spk1_step1.wav",
                     "mix1_spk0_step0.wav", "mix1_spk1_step1.wav"]
    wav, rate = read_wav(out / wrote[0])
    assert rate == 8000 and wav.shape == (3000,)
    assert np.isfinite(wav).all() and np.abs(wav).max() > 0


def test_cli_kernel_flags_and_resampling(tmp_path):
    """A 16 kHz input is resampled; the kernel route (plain versions on
    the CPU) writes the same files."""
    paths = _mixes(tmp_path, n=1, samples=6000, rate=16000)
    out = tmp_path / "out"
    cli.main([*paths, "--preset", "synth_tiny", "--speakers", "3,2",
              "--set", "use_pallas_rnn=true", "--set", "use_pallas_stft=1",
              "--set", "use_pallas_maskhead=yes", "--out", str(out),
              "--device", "cpu"])
    wav, _ = read_wav(out / "mix0_spk3_step0.wav")
    assert wav.shape == (3000,)


def test_cli_long_mode_covers_the_whole_file(tmp_path):
    paths = _mixes(tmp_path, n=1, samples=9000)
    out = tmp_path / "out"
    cli.main([*paths, "--preset", "synth_tiny", "--speakers", "0,1",
              "--long", "--out", str(out), "--device", "cpu"])
    for k in range(2):
        wav, _ = read_wav(out / f"mix0_ch{k}_long.wav")
        assert wav.shape == (9000,) and np.isfinite(wav).all()


def test_separate_long_short_input_equals_one_chunk():
    from dl4ss_tpu_torch import preset
    from dl4ss_tpu_torch.models import init_separator
    cfg = preset("synth_tiny")
    model = init_separator(cfg, torch.Generator().manual_seed(1), "cpu")
    wav = np.random.default_rng(1).uniform(-1, 1, 2500).astype(np.float32)
    long = cli.separate_long(model, wav, cfg, [0, 1])
    chunk = cli._separate_chunk(model, np.pad(wav, (0, cfg.max_len - 2500)),
                                cfg, [0, 1])
    np.testing.assert_allclose(long, chunk[:, :2500], atol=0)


@pytest.mark.parametrize("extra,message", [
    (["--checkpoint-dir", "ck"], "holds no checkpoint"),
    (["--graft", "encoder"], "component=ckpt_dir pairs"),
    (["--mode", "recursive", "--speakers", "0,1"], "teacher-forced"),
    (["--speakers", "0"], "top_k=2"),
    (["--speakers", "0,99"], "indices must be in"),
])
def test_cli_exits_with_a_one_line_message(tmp_path, extra, message):
    paths = _mixes(tmp_path, n=1)
    with pytest.raises(SystemExit, match=message):
        cli.main([*paths, "--preset", "synth_tiny", "--device", "cpu",
                  "--out", str(tmp_path / "out"), *extra])


def test_cli_default_device_needs_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device works")
    paths = _mixes(tmp_path, n=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([*paths, "--preset", "synth_tiny", "--speakers", "0,1",
                  "--out", str(tmp_path / "out")])


def _by_step(name):
    """mixI_spkS_stepK.wav -> (mixI, K): the order the CLI wrote them in."""
    return name.split("_")[0], name.rsplit("_", 1)[1]


def test_cli_classifier_selects_the_speakers(tmp_path, capsys):
    """Without --speakers the classifier's top-k names the files, and the
    waveforms equal those of a run forced to the same speakers."""
    paths = _mixes(tmp_path)
    out = tmp_path / "out"
    cli.main([*paths, "--preset", "synth_tiny", "--out", str(out),
              "--device", "cpu"])
    wrote = sorted((p.name for p in out.iterdir()), key=_by_step)
    assert len(wrote) == 4 and all("_spk" in w for w in wrote)
    spk = [w.split("_spk")[1].split("_")[0] for w in wrote
           if w.startswith("mix0")]
    forced = tmp_path / "forced"
    cli.main([paths[0], "--preset", "synth_tiny", "--speakers",
              ",".join(spk), "--out", str(forced), "--device", "cpu"])
    for name in (w for w in wrote if w.startswith("mix0")):
        a, _ = read_wav(out / name)
        b, _ = read_wav(forced / name)
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_cli_recursive_mode_writes_one_wav_per_step(tmp_path):
    paths = _mixes(tmp_path)
    out = tmp_path / "out"
    cli.main([*paths, "--preset", "synth_tiny", "--mode", "recursive",
              "--set", "recursive_max_steps=3", "--out", str(out),
              "--device", "cpu"])
    wrote = sorted((p.name for p in out.iterdir()), key=_by_step)
    assert len(wrote) == 6
    for stem in ("mix0", "mix1"):
        steps = [w for w in wrote if w.startswith(stem)]
        assert [w.rsplit("_", 1)[1] for w in steps] == [
            "step0.wav", "step1.wav", "step2.wav"]
        # each peel step extracts a different speaker
        assert len({w.split("_spk")[1].split("_")[0] for w in steps}) == 3
    wav, _ = read_wav(out / wrote[0])
    assert wav.shape == (3000,) and np.isfinite(wav).all()


def test_cli_long_mode_with_classifier_selection(tmp_path):
    """--long without --speakers: the classifier picks per chunk and the
    channels are aligned across chunks; the whole file comes back."""
    paths = _mixes(tmp_path, n=1, samples=9000)
    out = tmp_path / "out"
    cli.main([*paths, "--preset", "synth_tiny", "--long", "--out", str(out),
              "--device", "cpu"])
    for k in range(2):
        wav, _ = read_wav(out / f"mix0_ch{k}_long.wav")
        assert wav.shape == (9000,) and np.isfinite(wav).all()


def test_classify_cli_trains_and_reports(tmp_path, capsys):
    from dl4ss_tpu_torch.run import classify
    metrics = tmp_path / "metrics.jsonl"
    report = classify.main([
        "--preset", "synth_tiny", "--device", "cpu", "--epochs", "1",
        "--epoch-size", "2", "--eval-batches", "2", "--utts", "2",
        "--metrics", str(metrics)])
    assert set(report) == {
        "element_acc", "sample_acc", "hamming_loss", "micro_precision",
        "micro_recall", "micro_f1", "macro_precision", "macro_recall",
        "macro_f1", "top3_recall"}
    assert all(0.0 <= v <= 1.0 for v in report.values())
    rec = json.loads(metrics.read_text().splitlines()[-1])
    assert rec["kind"] == "epoch" and rec["step"] == 2
    assert np.isfinite([rec["loss"], rec["element_acc"]]).all()
    assert "si_sdr" not in rec
    assert "top3_recall:" in capsys.readouterr().out


def test_train_cli_classifier_mode(tmp_path):
    from dl4ss_tpu_torch.run import train
    metrics = tmp_path / "metrics.jsonl"
    state = train.main([
        "--preset", "synth_tiny", "--device", "cpu", "--mode", "classifier",
        "--epochs", "1", "--epoch-size", "2", "--utts", "2", "--metrics",
        str(metrics)])
    assert state.step == 2
    rec = json.loads(metrics.read_text().splitlines()[-1])
    assert np.isfinite([rec["loss"], rec["element_acc"],
                        rec["si_sdr"]]).all()


@pytest.mark.parametrize("argv,message", [
    (["--eval-only", "--checkpoint-dir", "ck"], "holds no checkpoint"),
    (["--eval-only"], "restores --checkpoint-dir"),
])
def test_classify_cli_exits_with_a_one_line_message(argv, message):
    from dl4ss_tpu_torch.run import classify
    with pytest.raises(SystemExit, match=message):
        classify.main(["--preset", "synth_tiny", "--device", "cpu", *argv])


@pytest.mark.parametrize("argv,message", [
    (["--mode", "memory", "--file-lists", "nolists"],
     "no speaker vocabulary"),
    (["--mode", "memory", "--unk-holdout", "2", "--utts", "2"],
     "unk_spk=true"),
    (["--mode", "memory", "--query-source", "video", "--unk-holdout", "2",
      "--utts", "2"], "voiceprint"),
    (["--set", "min_mix=1", "--set", "max_mix=1"], "top_k=2"),
    (["--mode", "recursive", "--teacher-forced"], "selects one speaker"),
    (["--candidates", "1"], "--candidates must be >= top_k"),
])
def test_evaluate_cli_exits_with_a_one_line_message(argv, message):
    """run.evaluate refuses, with the JAX CLI's words, the combinations it
    cannot score: the wavlist protocol without a speaker vocabulary,
    unknown-speaker evaluation of a model without the unk row or with a
    non-speech query."""
    from dl4ss_tpu_torch.run import evaluate
    with pytest.raises(SystemExit, match=message):
        evaluate.main(["--preset", "synth_tiny", "--device", "cpu", *argv])


def test_evaluate_cli_mixed_speaker_counts(capsys):
    """min_mix=1: mixtures of one or two live speakers from the synthetic
    sampler, scored with the complement mask (random weights from --seed)."""
    from dl4ss_tpu_torch.run import evaluate
    score = evaluate.main(["--preset", "synth_tiny", "--device", "cpu",
                           "--utts", "2", "--batches", "1", "--set",
                           "min_mix=1", "--set", "max_mix=2",
                           "--complement-mask", "--dedup"])
    assert np.isfinite(score)
    assert "SI-SDR over 1 batches" in capsys.readouterr().out
