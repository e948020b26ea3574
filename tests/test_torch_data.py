"""The port's data sources against the JAX package on the CPU: the wsj0-mix
lists, the native loader, speaker trees, the list sampler, the device
prefetch, the timbre bank and the host tools that write corpora. Every
corpus is written here from a seed (`generate_corpus` at 0.25 s), so
nothing is downloaded."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl4ss_tpu import native as jax_native
from dl4ss_tpu import preset as jax_preset
from dl4ss_tpu.data import dirtree as jax_dirtree
from dl4ss_tpu.data import layout_tools as jax_layout
from dl4ss_tpu.data import listsampler as jax_lists
from dl4ss_tpu.data import rehearsal as jax_rehearsal
from dl4ss_tpu.data import wsj0mix as jax_wsj0mix
from dl4ss_tpu.data.synth import make_synthetic_bank as jax_bank
from dl4ss_tpu.data.wavio import write_wav
from dl4ss_tpu_torch import native, preset
from dl4ss_tpu_torch.data import dirtree, layout_tools, listsampler, wsj0mix
from dl4ss_tpu_torch.data.loader import device_prefetch, to_pinned
from dl4ss_tpu_torch.data.rehearsal import generate_corpus
from dl4ss_tpu_torch.data.synth import make_synthetic_bank
from dl4ss_tpu_torch.run.common import write_vocab

SECONDS = 0.25
OVER = dict(max_len_seconds=SECONDS)
CORPUS = dict(n_spk=5, utts=4, seconds=SECONDS, tr_entries=9, cv_entries=8,
              tt_entries=8, mix_ks=(1, 2, 3), cv_holdout=1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A rehearsal corpus of 5 speakers x 4 utterances with k = 1, 2 and 3
    lists, written by the port."""
    root = tmp_path_factory.mktemp("corpus")
    generate_corpus(str(root), **CORPUS)
    return str(root)


def _cfgs():
    return (jax_preset("synth_tiny").replace(**OVER),
            preset("synth_tiny").replace(**OVER))


def test_mix_lines_lists_and_vocabulary_equal_jax(corpus):
    lines = ["wsj0/si_tr_s/011/011a0101.wav 0.93421 "
             "wsj0/si_tr_s/01a/01ac0207.wav -0.93421",
             "a/b/x12/ab.wav 1.5", "wsj0/si_tr_s/012/012c0207.wav -2.5"]
    for line in lines:
        assert wsj0mix.parse_mix_line(line) == jax_wsj0mix.parse_mix_line(
            line)
    with pytest.raises(ValueError):
        wsj0mix.parse_mix_line("only/one/token.wav")
    for k in (1, 2, 3):
        for split in ("train", "valid", "test"):
            name = wsj0mix.mix_list_name(k, split)
            assert name == jax_wsj0mix.mix_list_name(k, split)
            path = os.path.join(corpus, "lists", name)
            ours = wsj0mix.parse_mix_list(path)
            assert ours == jax_wsj0mix.parse_mix_list(path)
            assert (wsj0mix.speakers_in_lists(ours)
                    == jax_wsj0mix.speakers_in_lists(ours))


def _wavs(tmp_path, rng):
    """Six wavs: 8 kHz of several lengths (crop and pad), and one at 16
    kHz (resampled)."""
    paths = []
    for i in range(5):
        p = tmp_path / f"u{i}.wav"
        write_wav(p, 0.4 * rng.standard_normal(1500 + 300 * i) + 0.05, 8000)
        paths.append(str(p))
    p = tmp_path / "hi.wav"
    write_wav(p, 0.4 * rng.standard_normal(5000), 16000)
    return paths + [str(p)]


@pytest.mark.parametrize("normalize", [True, False])
def test_native_loader_equals_jax_loader_and_plain(tmp_path, normalize):
    """The port's build of its own loader.cc against the JAX package's
    build: bit-equal. Both against the numpy `_load_fixed`: 1e-6 at the
    file's rate, 5e-5 resampled (tests/test_native.py's bars)."""
    paths = _wavs(tmp_path, np.random.default_rng(0))
    ours = native.load_batch(paths, 8000, 2200, normalize=normalize,
                             num_threads=3)
    ref = jax_native.load_batch(paths, 8000, 2200, normalize=normalize)
    np.testing.assert_array_equal(ours, ref)
    plain = np.stack([dirtree._load_fixed(p, 8000, 2200, normalize)
                      for p in paths])
    np.testing.assert_array_equal(
        plain, np.stack([jax_dirtree._load_fixed(p, 8000, 2200, normalize)
                         for p in paths]))
    np.testing.assert_allclose(ours[:5], plain[:5], atol=1e-6)
    np.testing.assert_allclose(ours[5], plain[5], atol=5e-5)
    one = native.load_utterance(paths[2], 8000, 2200, normalize=normalize)
    np.testing.assert_array_equal(one, ours[2])
    wav, rate = native.decode_wav(paths[5])
    assert rate == 16000 and wav.shape == (5000,)


def test_native_loader_failures_raise(tmp_path, monkeypatch):
    """A missing file raises, and so does a failed build, with the
    compiler's message: nothing falls back to numpy."""
    with pytest.raises(ValueError, match="1 file"):
        native.load_batch([str(tmp_path / "missing.wav")], 8000, 100)
    bad = tmp_path / "loader.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "_build")
    native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="native loader build failed"):
            native.load_batch([str(bad)], 8000, 100)
    finally:
        native.library.cache_clear()


@pytest.mark.parametrize("up,down,n", [(1, 2, 4000), (2, 1, 1000),
                                       (2, 3, 1001)])
def test_native_resample_poly_matches_jax_and_scipy(up, down, n):
    """`native.resample_poly` (the port's binding of its loader.cc) against
    the JAX package's binding of its own: bit-equal; against
    scipy.signal.resample_poly with the same Kaiser window in float64:
    5e-5 (tests/test_native.py's bar), the same output length."""
    import scipy.signal
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    ours = native.resample_poly(x, up, down)
    np.testing.assert_array_equal(ours, jax_native.resample_poly(x, up,
                                                                 down))
    ref = scipy.signal.resample_poly(
        x.astype(np.float64), up, down,
        window=("kaiser", native.KAISER_BETA)).astype(np.float32)
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=5e-5)


def test_native_available_and_build_error_report_the_build(tmp_path,
                                                           monkeypatch):
    """`available()` / `build_error()` as JAX's: True and None where the
    library builds; False and the compiler's output where it does not."""
    assert native.available() and native.build_error() is None
    bad = tmp_path / "loader.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "_build")
    native.library.cache_clear()
    try:
        assert not native.available()
        assert "native loader build failed" in native.build_error()
    finally:
        native.library.cache_clear()


@pytest.mark.parametrize("utts,tree", [(None, False), (2, False),
                                       (None, True)])
def test_load_bank_utts_per_speaker_matches_jax(corpus, utts, tree):
    """`run.common.load_bank(..., utts_per_speaker=3)` as JAX's: 3
    utterances a speaker unless --utts gives a count, which wins; from the
    synthetic bank or a speaker tree, the same bank, speaker count and
    names."""
    import argparse
    from dl4ss_tpu.run.common import load_bank as jax_load_bank
    from dl4ss_tpu_torch.run.common import load_bank
    cfg_j, cfg_t = _cfgs()
    args = argparse.Namespace(
        seed=4, utts=utts, utts_from=0, split="si_tr_s",
        data_root=os.path.join(corpus, "wsj0") if tree else None)
    bank, cfg, names = load_bank(cfg_t, args, "cpu", utts_per_speaker=3)
    ref, ref_cfg, ref_names = jax_load_bank(cfg_j, args, utts_per_speaker=3)
    assert bank.shape[1] == (utts or 3)
    np.testing.assert_array_equal(bank.numpy(), np.asarray(ref))
    assert (cfg.num_speakers, names) == (ref_cfg.num_speakers, ref_names)


def test_dirtree_bank_equals_jax_and_held_out_slice_refuses_to_wrap(corpus):
    cfg_j, cfg_t = _cfgs()
    root = os.path.join(corpus, "wsj0")
    assert (dirtree.scan_speaker_tree(root, "si_tr_s")
            == jax_dirtree.scan_speaker_tree(root, "si_tr_s"))
    for utts, offset in ((3, 0), (2, 2), (6, 0)):
        ours = dirtree.DirTreeSampler(root, cfg_t, "si_tr_s", utts, offset)
        ref = jax_dirtree.DirTreeSampler(root, cfg_j, "si_tr_s", utts,
                                         offset)
        np.testing.assert_array_equal(ours.bank, ref.bank)
        assert ours.idx2spk == ref.idx2spk and ours.num_speakers == 5
    with pytest.raises(ValueError, match="wraps"):
        dirtree.DirTreeSampler(root, cfg_t, "si_tr_s", 2, utts_offset=3)
    assert (dirtree.split_for_train_dev_test([str(i) for i in range(13)])
            == jax_dirtree.split_for_train_dev_test(
                [str(i) for i in range(13)]))


def test_streaming_tree_sampler_equals_jax(corpus):
    """The same numpy draws and the same loader: equal batches. Contract:
    distinct speakers an item, rows normalized before the pad, mix = the
    sum of the sources."""
    cfg_j, cfg_t = _cfgs()
    root = os.path.join(corpus, "wsj0")
    ours = list(dirtree.StreamingTreeSampler(root, cfg_t, "si_tr_s", seed=3)
                .batches(3, 2))
    ref = list(jax_dirtree.StreamingTreeSampler(root, cfg_j, "si_tr_s",
                                                seed=3).batches(3, 2))
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
        assert all(len(set(row)) == cfg_t.max_mix for row in a["spk_idx"])
        np.testing.assert_allclose(np.abs(a["source_wavs"]).max(-1), 1.0,
                                   atol=1e-6)
        np.testing.assert_allclose(a["mix_wav"], a["source_wavs"].sum(1),
                                   atol=1e-6)


def test_device_prefetch_on_the_cpu():
    batches = [{"mix_wav": np.full((2, 5), i, np.float32),
                "spk_idx": np.array([[i, i + 1]], np.int32)}
               for i in range(5)]
    out = list(device_prefetch(iter(batches), depth=2, device="cpu"))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert isinstance(b["mix_wav"], torch.Tensor)
        assert b["spk_idx"].dtype == torch.int32
        np.testing.assert_array_equal(b["mix_wav"].numpy(),
                                      batches[i]["mix_wav"])
    if torch.cuda.is_available():      # pinning needs a CUDA runtime
        assert to_pinned(batches[0])["mix_wav"].is_pinned()


@pytest.mark.parametrize("timbre", [True, False])
def test_synthetic_bank_is_bit_identical_to_jax(timbre):
    np.testing.assert_array_equal(
        make_synthetic_bank(5, 3, 2, 800, timbre=timbre),
        jax_bank(5, 3, 2, 800, timbre=timbre))


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_generated_corpus_lists_and_layouts_are_byte_equal(tmp_path,
                                                           corpus):
    jax_rehearsal.generate_corpus(str(tmp_path / "jax"), **CORPUS)
    ours, ref = _files(corpus), _files(tmp_path / "jax")
    assert len(ours) == 5 * 4 + 9 and ours == ref
    # layout_wsj0 and the Cocktail file lists from one flat dump
    flat = tmp_path / "flat"
    flat.mkdir()
    for spk in ("011", "012", "013", "014"):
        for u in range(3):
            write_wav(flat / f"{spk}c{u:04d}.wav", np.zeros(10), 8000)
    split = {"train": ["011", "012"], "dev": ["013"], "test": ["014"]}
    for mod, side in ((layout_tools, "port"), (jax_layout, "jax")):
        assert mod.layout_wsj0(str(flat), str(tmp_path / side), split) == {
            "train": 6, "dev": 3, "test": 3}
        lists = mod.generate_file_lists(str(tmp_path / side / "data"),
                                        str(tmp_path / side / "lists"),
                                        seed=3)
        assert sorted(lists) == ["dev", "test", "train"]
    for name in ("train_wavlist.txt", "dev_wavlist.txt",
                 "test_wavlist.txt"):
        port = (tmp_path / "port" / "lists" / name).read_text()
        assert port.replace("/port/", "/jax/") == (
            tmp_path / "jax" / "lists" / name).read_text()


def _samplers(corpus, split="train", spk2idx=None, ks=(1, 2, 3)):
    cfg_j, cfg_t = _cfgs()
    lists = os.path.join(corpus, "lists")
    ours = listsampler.Wsj0MixSampler(lists, corpus, cfg_t, split,
                                      mix_ks=ks, spk2idx=spk2idx,
                                      device="cpu")
    ref = jax_lists.Wsj0MixSampler(lists, corpus, cfg_j, split, mix_ks=ks,
                                   spk2idx=spk2idx)
    return ours, ref, cfg_j, cfg_t


@pytest.mark.parametrize("seed", [0, 3])
def test_sampler_epochs_bank_and_tables_equal_jax(corpus, seed):
    """Mixed k = 1, 2, 3 pools, with the list vocabulary and with an
    injected one that names an unlisted speaker: identical index arrays
    in every epoch batch, the same bank, speaker tables and batch count."""
    ours, ref, _, _ = _samplers(corpus)
    vocab = dict(ref.spk2idx, **{"099": len(ref.spk2idx)})
    injected = _samplers(corpus, "valid", spk2idx=vocab)
    for o, r in ((ours, ref), injected[:2]):
        assert o.spk2idx == r.spk2idx and o.k == r.k == 3
        np.testing.assert_array_equal(o.bank, r.bank)
        np.testing.assert_array_equal(o.spk_rows, r.spk_rows)
        np.testing.assert_array_equal(o.spk_counts, r.spk_counts)
        assert o.num_batches(4) == r.num_batches(4) == 6
        got = list(o.epoch(4, shuffle=True, seed=seed))
        want = list(r.epoch(4, shuffle=True, seed=seed))
        assert len(got) == len(want) == 6
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    assert injected[0].spk_counts[-1] == 0        # "099" is in no entry
    with pytest.raises(ValueError, match="absent from the provided"):
        _samplers(corpus, "valid", spk2idx={"011": 0})


def test_vocab_sidecar_is_byte_equal_to_jax(tmp_path, corpus):
    ours, ref, _, _ = _samplers(corpus)
    write_vocab(str(tmp_path), ours.spk2idx)
    with open(tmp_path / "jax_vocab.json", "w") as fh:
        json.dump(ref.spk2idx, fh)           # as dl4ss_tpu.run.train does
    assert ((tmp_path / "vocab.json").read_bytes()
            == (tmp_path / "jax_vocab.json").read_bytes())


def test_mix_from_list_equals_jax_and_the_shift_is_a_roll(corpus):
    """Without a shift: within 1e-6 of JAX's batch (a padded channel has
    zero gain). The random shift (drawn from a torch generator, which JAX
    cannot reproduce) by its contract: each source is the unshifted one
    rolled by some amount."""
    ours, ref, cfg_j, cfg_t = _samplers(corpus)
    bank_j = jnp.asarray(ref.bank)
    for utt, db, spk, live in ref.epoch(4, seed=1):
        want = jax_lists.mix_from_list(bank_j, jnp.asarray(utt),
                                       jnp.asarray(db), jnp.asarray(spk),
                                       cfg_j, live=jnp.asarray(live))
        got = ours.to_batch(utt, db, spk, live)
        for key in ("mix_wav", "source_wavs", "gains"):
            np.testing.assert_allclose(getattr(got, key).numpy(),
                                       np.asarray(getattr(want, key)),
                                       atol=1e-6)
        np.testing.assert_array_equal(got.spk_idx.numpy(), spk)
        np.testing.assert_array_equal(got.utt_idx.numpy(), utt)
    shifts = torch.tensor([[5, 0, 17]] * len(utt))
    rolled = ours.to_batch(utt, db, spk, live, shifts=shifts)
    np.testing.assert_array_equal(
        rolled.source_wavs.numpy(),
        np.stack([[np.roll(w, s) for w, s in zip(row, srow)]
                  for row, srow in zip(got.source_wavs.numpy(),
                                       shifts.numpy())]))
    aug = next(ours.batches(4, seed=1, augment=True))
    assert aug.source_wavs.shape == got.source_wavs.shape
    again = next(ours.batches(4, seed=1, augment=True))
    torch.testing.assert_close(aug.mix_wav, again.mix_wav, atol=0, rtol=0)


def test_same_speaker_rows_and_real_pool_equal_jax(corpus):
    """draw_same_speaker_rows with the draws r given (JAX's own, from its
    key) equals JAX's, collision bump included; the real pool's spectra
    within 1e-4, dead padded channels zero on both sides."""
    ours, ref, cfg_j, cfg_t = _samplers(corpus)
    rows_t, counts_t = ours.spk_tables()
    bank_j = jnp.asarray(ref.bank)
    for i, (utt, db, spk, live) in enumerate(ref.epoch(4, seed=2)):
        key = jax.random.PRNGKey(i)
        r = jax.random.randint(key, spk.shape, 0, 1 << 30)
        want = jax_lists.draw_same_speaker_rows(
            key, jnp.asarray(spk), jnp.asarray(utt),
            jnp.asarray(ref.spk_rows), jnp.asarray(ref.spk_counts))
        live_ch = live > 0
        got = listsampler.draw_same_speaker_rows(
            torch.as_tensor(spk).long(), torch.as_tensor(utt).long(),
            rows_t, counts_t, torch.as_tensor(np.array(r)).long())
        np.testing.assert_array_equal(got.numpy()[live_ch],
                                      np.asarray(want)[live_ch])
        batch_j = jax_lists.mix_from_list(bank_j, jnp.asarray(utt),
                                          jnp.asarray(db), jnp.asarray(spk),
                                          cfg_j, live=jnp.asarray(live))
        spec_j = np.asarray(jax_lists.list_same_speaker_real_specs(
            key, batch_j, bank_j, jnp.asarray(ref.spk_rows),
            jnp.asarray(ref.spk_counts), cfg_j))
        r_t = torch.as_tensor(np.array(r)).long()
        spec_t = listsampler.list_same_speaker_real_specs(
            None, ours.to_batch(utt, db, spk, live), ours.device_bank(),
            rows_t, counts_t, cfg_t, r=r_t).numpy()
        assert not spec_t[~live_ch].any() and not spec_j[~live_ch].any()
        np.testing.assert_allclose(spec_t, spec_j, atol=1e-4)
        # a different utterance of the same speaker wherever it has one
        gen = torch.Generator().manual_seed(i)
        drawn = listsampler.draw_same_speaker_rows(
            torch.as_tensor(spk).long(), torch.as_tensor(utt).long(),
            rows_t, counts_t, listsampler.speaker_draws(gen, spk.shape))
        multi = live_ch & (ours.spk_counts[spk] > 1)
        assert (drawn.numpy()[multi] != utt[multi]).all()
