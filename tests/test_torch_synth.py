"""The port's mixture synthesis and featurization against the JAX package
on the CPU. jax.random streams cannot be reproduced in torch, so
`sample_mixtures` is held to its contract; the bank is numpy and must be
bit-identical; `featurize` and `normalize_utterance` are compared on the
same injected inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl4ss_tpu import preset as jax_preset
from dl4ss_tpu.data.synth import MixtureBatch as JaxBatch
from dl4ss_tpu.data.synth import featurize as jax_featurize
from dl4ss_tpu.data.synth import make_synthetic_bank as jax_bank
from dl4ss_tpu.data.synth import normalize_utterance as jax_normalize
from dl4ss_tpu_torch import preset
from dl4ss_tpu_torch.data.synth import (MixtureBatch, featurize,
                                        make_synthetic_bank,
                                        normalize_utterance, sample_mixtures)


def test_bank_is_bit_identical():
    ours = make_synthetic_bank(3, 4, 2, 1000)
    ref = jax_bank(3, 4, 2, 1000)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def test_normalize_utterance_matches():
    x = np.random.default_rng(0).standard_normal((3, 2, 500)).astype(
        np.float32) * 3 + 1
    ours = normalize_utterance(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_normalize(jnp.asarray(x))),
                               atol=1e-6)
    assert np.allclose(np.abs(ours).max(-1), 1.0)


def _norm(w):
    w = w - w.mean()
    return w / max(np.abs(w).max(), 1e-8)


def _bank(cfg, utts=3):
    return torch.as_tensor(make_synthetic_bank(0, cfg.num_speakers, utts,
                                               cfg.max_len))


def test_sample_mixtures_plain_contract():
    """Distinct speakers, unity gains without augmentation, sources are
    the normalized bank rows, and they sum to the mixture."""
    cfg = preset("synth_tiny")
    bank = _bank(cfg)
    b = sample_mixtures(torch.Generator().manual_seed(0), bank, cfg)
    assert b.mix_wav.shape == (cfg.batch_size, cfg.max_len)
    assert b.source_wavs.shape == (cfg.batch_size, 2, cfg.max_len)
    spk = b.spk_idx.numpy()
    assert all(len(set(row)) == len(row) for row in spk)
    assert (spk >= 0).all() and (spk < cfg.num_speakers).all()
    np.testing.assert_array_equal(b.gains.numpy(), 1.0)
    torch.testing.assert_close(b.source_wavs.sum(1), b.mix_wav, atol=1e-6,
                               rtol=0)
    for i in range(cfg.batch_size):
        for k in range(2):
            np.testing.assert_allclose(
                b.source_wavs[i, k].numpy(),
                _norm(bank[spk[i, k], b.utt_idx[i, k]].numpy()), atol=1e-6)
    again = sample_mixtures(torch.Generator().manual_seed(0), bank, cfg)
    assert torch.equal(again.mix_wav, b.mix_wav)


def test_sample_mixtures_two_speaker_gains_and_shifts():
    """k=2 with augmentation: one channel scaled by 10^(dB/20 * r) with r
    in [0, 1), the other unity; each source is a circular shift of its
    normalized utterance times its gain; sources sum to the mix."""
    cfg = preset("synth_tiny").replace(augment_data=True, db_range=6.0,
                                       batch_size=32)
    bank = _bank(cfg)
    b = sample_mixtures(torch.Generator().manual_seed(1), bank, cfg)
    gains = b.gains.numpy()
    hi = 10 ** (6.0 / 20)
    assert ((gains == 1.0).sum(1) >= 1).all()
    assert ((gains >= 1.0) & (gains <= hi)).all()
    assert (gains.max(1) > 1.0).any()
    torch.testing.assert_close(b.source_wavs.sum(1), b.mix_wav, atol=1e-6,
                               rtol=0)
    shifted = 0
    for i in range(4):
        for k in range(2):
            row = _norm(bank[b.spk_idx[i, k], b.utt_idx[i, k]].numpy())
            src = b.source_wavs[i, k].numpy() / gains[i, k]
            shift = int(np.argmax([np.dot(np.roll(row, s), src)
                                   for s in range(len(row))]))
            np.testing.assert_allclose(np.roll(row, shift), src, atol=1e-5)
            shifted += shift != 0
    assert shifted > 0


def test_sample_mixtures_live_gating_and_three_speaker_gains():
    """min_mix < max_mix: each item has 1..3 live channels, dead channels
    have zero gain and zero source; a 3-live item takes the normal / large
    / small trio, a 2-live item the k=2 rule."""
    cfg = preset("synth_tiny").replace(min_mix=1, max_mix=3, top_k=3,
                                       augment_data=True, db_range=6.0,
                                       batch_size=48)
    b = sample_mixtures(torch.Generator().manual_seed(2), _bank(cfg), cfg)
    gains = b.gains.numpy()
    live = (gains > 0).sum(1)
    assert set(live) == {1, 2, 3}
    for g, n in zip(gains, live):
        assert (g[:n] > 0).all() and (g[n:] == 0).all()
    s = 6.0 / 20
    trio = gains[live == 3]
    np.testing.assert_allclose(trio[:, 0], 10 ** (s * 0.5), rtol=1e-6)
    assert ((trio[:, 1] >= 10 ** (s * 0.5) - 1e-6)
            & (trio[:, 1] <= 10 ** s)).all()
    assert ((trio[:, 2] >= 1.0) & (trio[:, 2] <= 10 ** (s * 0.5))).all()
    two = gains[live == 2][:, :2]
    assert ((two == 1.0).sum(1) >= 1).all() and (two <= 10 ** s).all()
    np.testing.assert_array_equal(gains[live == 1], [[1.0, 0.0, 0.0]] *
                                  int((live == 1).sum()))
    dead = torch.as_tensor(gains == 0)
    assert (b.source_wavs[dead] == 0).all()
    torch.testing.assert_close(b.source_wavs.sum(1), b.mix_wav, atol=1e-6,
                               rtol=0)


def test_sample_mixtures_eval_and_noise():
    """train=False: no shift, unity gains. With a noise bank the mixture
    gets 0.3 x a circularly shifted noise row; the sources stay clean."""
    cfg = preset("synth_tiny").replace(augment_data=True, db_range=6.0,
                                       add_bgd_noise=True)
    bank = _bank(cfg)
    b = sample_mixtures(torch.Generator().manual_seed(3), bank, cfg,
                        train=False)
    np.testing.assert_array_equal(b.gains.numpy(), 1.0)
    noise = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (2, cfg.max_len + 50)).astype(np.float32))
    b = sample_mixtures(torch.Generator().manual_seed(3), bank, cfg,
                        noise_bank=noise)
    extra = ((b.mix_wav - b.source_wavs.sum(1)) / cfg.bgd_noise_ratio).numpy()
    for row in extra:
        assert any(np.allclose(np.sort(row),
                               np.sort(noise[j, :cfg.max_len].numpy()),
                               atol=1e-4) for j in range(2))


@pytest.mark.parametrize("flags", [False, True])
@pytest.mark.parametrize("crm", [False, True])
def test_featurize_matches_jax(flags, crm):
    """One injected batch through JAX `featurize` (Pallas K1 in interpret
    mode when the flag is on) and the port's (K1's plain version on the
    CPU): every feature within 1e-4, the reference's DSP bar; cRM configs
    also get the sources' packed spectra."""
    over = dict(use_pallas_stft=True) if flags else {}
    over["is_complex_mask"] = crm
    cfg_j = jax_preset("synth_tiny").replace(**over)
    cfg_t = preset("synth_tiny").replace(**over)
    rng = np.random.default_rng(5)
    src = rng.uniform(-0.5, 0.5, (3, 2, cfg_j.max_len)).astype(np.float32)
    gains = np.array([[1.0, 1.0], [1.5, 0.0], [1.0, 2.0]], np.float32)
    src = src * gains[..., None]
    spk = np.array([[0, 1], [2, 3], [4, 5]])
    ref = jax_featurize(JaxBatch(jnp.asarray(src.sum(1)), jnp.asarray(src),
                                 jnp.asarray(spk), jnp.asarray(gains)), cfg_j)
    ours = featurize(MixtureBatch(torch.as_tensor(src.sum(1)),
                                  torch.as_tensor(src), torch.as_tensor(spk),
                                  torch.as_tensor(gains)), cfg_t)
    assert set(ours) == set(ref)
    for key in ref:
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-4, err_msg=key)
