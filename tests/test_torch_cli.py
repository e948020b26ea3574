"""The port's separation CLI on the CPU (`--device cpu`) at synth_tiny."""

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
    (["--checkpoint-dir", "ck"], "P7"),
    (["--graft", "encoder=ck"], "P7"),
    (["--mode", "recursive", "--speakers", "0,1"], "K7"),
    ([], "classifier selection"),
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
