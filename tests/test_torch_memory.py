"""The port's life-long speaker memory and memory trainer (ROADMAP P12)
against the JAX package's on the CPU: the memory's write (both modes, with
duplicate speakers in a batch), read, reset and extend; one memory train
step (speech and image queries, MSE and si_sdr losses), the eval step and
`enroll` from the same parameters (`load_jax_params`), memory
(`memory_from_jax`) and features; the early stop; and the CLIs end to end
(`run.train --mode memory` on a speaker tree and on the Cocktail
wavlists, resume, warm start, `run.evaluate --mode memory` with unknown
speakers)."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl4ss_tpu import preset as jax_preset
from dl4ss_tpu.data.mnist import digit_query_bank as jax_digit_bank
from dl4ss_tpu.data.mnist import load_mnist as jax_load_mnist
from dl4ss_tpu.data.synth import featurize as jax_featurize
from dl4ss_tpu.data.synth import linear_target_mags as jax_target_mags
from dl4ss_tpu.data.synth import make_synthetic_bank as jax_bank
from dl4ss_tpu.data.synth import sample_mixtures as jax_sample
from dl4ss_tpu.models import memory as jmem
from dl4ss_tpu.train import memory_trainer as jmt
from dl4ss_tpu_torch import preset
from dl4ss_tpu_torch.data.layout_tools import generate_file_lists
from dl4ss_tpu_torch.data.rehearsal import cocktail_layout, generate_corpus
from dl4ss_tpu_torch.data.synth import MixtureBatch, linear_target_mags
from dl4ss_tpu_torch.models import memory as tmem
from dl4ss_tpu_torch.train import memory_trainer as tmt
from dl4ss_tpu_torch.weights import (export_jax_params, flatten_tree,
                                     load_jax_params)
from torch_step_parity import assert_step_matches, jax_step, torch_step

SMALL = dict(hidden_units=16, embedding_size=8, max_len_seconds=0.5,
             num_speakers=6, batch_size=3, num_layers=1, encoder_layers=1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _state(preset_name="cocktail_debug", query_source="speech", seed=0,
           **over):
    """Both configs, the JAX memory state, and the port's state from the
    same parameters and memory."""
    over = {**SMALL, **over}
    cfg_j = jax_preset(preset_name).replace(**over)
    cfg_t = preset(preset_name).replace(**over)
    state_j = jmt.create_memory_state(jax.random.PRNGKey(seed), cfg_j,
                                      query_source)
    state_t = tmt.create_memory_state(cfg_t, seed, query_source,
                                      device="cpu")
    load_jax_params(state_t.model, _np_tree(state_j.params))
    return cfg_j, state_j, cfg_t, state_t


def _feats(cfg_j, seed=1, query_source="speech", repeat_target=True):
    """One memory-mode batch from JAX's sampler, as numpy; the first two
    items share their target speaker, so the writes carry a duplicate."""
    bank = jnp.asarray(jax_bank(seed, cfg_j.num_speakers, 2, cfg_j.max_len))
    b = jax_sample(jax.random.PRNGKey(seed), bank, cfg_j)
    if repeat_target:
        spk = b.spk_idx.at[1].set(b.spk_idx[0])
        b = b._replace(spk_idx=spk)
    f = jax_featurize(b, cfg_j)
    mix_mag, target_mag = jax_target_mags(f, b, cfg_j)
    feats = {"mix_feas": f["mix_feas"], "mix_mag": mix_mag,
             "spk_id": b.spk_idx[:, 0], "clean_feas": f["src_feas"][:, 0],
             "target_mag": target_mag, "mix_ri": f["mix_ri"],
             "target_wav": b.source_wavs[:, 0]}
    if query_source == "image":
        imgs, labels = jax_load_mnist(None, fallback_per_digit=4)
        digits = jax_digit_bank(imgs, labels, cfg_j.num_speakers)
        feats["query_image"] = digits[np.asarray(b.spk_idx[:, 0]), 0]
    return {k: np.array(v) for k, v in feats.items()}


def _t(feats):
    return {k: torch.as_tensor(v) for k, v in feats.items()}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _random_memory(rng, rows=5, dim=4):
    vec = rng.standard_normal((rows, 3, dim)).astype(np.float32)
    vec[1] = 0.0                                 # an empty row
    age = rng.integers(0, 4, (rows, 3)).astype(np.int32)
    return vec, age


@pytest.mark.parametrize("mode", ["keras", "torch"])
def test_memory_write_and_read_match_jax(mode):
    """A batched write with a duplicate and an untouched row, into a memory
    with an all-zero row (the zero guard), then a read: 1e-6; ages equal.
    The rows are summed as a one-hot product, bit-for-bit repeatable."""
    rng = np.random.default_rng(0)
    vec, age = _random_memory(rng)
    spk = np.array([2, 1, 2, 4], np.int32)
    incoming = rng.standard_normal((4, 4)).astype(np.float32)
    incoming[3] = 0.0
    ref = jmem.memory_write_slot(jmem.MemorySlots(jnp.asarray(vec),
                                                  jnp.asarray(age)),
                                 jnp.asarray(spk), jnp.asarray(incoming),
                                 jmem.SLOT_IMAGE, mode)
    ours = tmem.memory_write_slot(tmem.MemorySlots(torch.as_tensor(vec),
                                                   torch.as_tensor(age)),
                                  torch.as_tensor(spk),
                                  torch.as_tensor(incoming), tmem.SLOT_IMAGE,
                                  mode)
    np.testing.assert_allclose(ours.vectors.numpy(), np.asarray(ref.vectors),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ours.age.numpy(), np.asarray(ref.age))
    again = tmem.memory_write_slot(tmem.MemorySlots(torch.as_tensor(vec),
                                                    torch.as_tensor(age)),
                                   torch.as_tensor(spk),
                                   torch.as_tensor(incoming),
                                   tmem.SLOT_IMAGE, mode)
    assert torch.equal(again.vectors, ours.vectors)
    np.testing.assert_allclose(
        tmem.memory_read(ours, torch.as_tensor(spk), tmem.SLOT_IMAGE).numpy(),
        np.asarray(jmem.memory_read(ref, jnp.asarray(spk), jmem.SLOT_IMAGE)),
        atol=1e-6, rtol=0)


def test_memory_write_alias_matches_jax():
    """`memory_write`, JAX's alias of `memory_write_slot` at the speech
    slot in keras mode, with a duplicate speaker: 1e-6, ages equal."""
    rng = np.random.default_rng(5)
    vec, age = _random_memory(rng)
    spk = np.array([0, 3, 0], np.int32)
    incoming = rng.standard_normal((3, 4)).astype(np.float32)
    ref = jmem.memory_write(jmem.MemorySlots(jnp.asarray(vec),
                                             jnp.asarray(age)),
                            jnp.asarray(spk), jnp.asarray(incoming))
    ours = tmem.memory_write(tmem.MemorySlots(torch.as_tensor(vec),
                                              torch.as_tensor(age)),
                             torch.as_tensor(spk), torch.as_tensor(incoming))
    np.testing.assert_allclose(ours.vectors.numpy(), np.asarray(ref.vectors),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ours.age.numpy(), np.asarray(ref.age))


def test_train_state_with_memory_matches_jax_and_checkpoints(tmp_path):
    """`create_train_state(with_memory=True)` holds an empty speaker memory
    of memory_rows(cfg) x 3 slots x cfg.query_dim (the unk row with
    cfg.unk_spk), as JAX's state does; without it, none. A write into it
    survives a checkpoint's save and restore."""
    from dl4ss_tpu.train.state import create_train_state as jax_state
    from dl4ss_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                  save_checkpoint)
    from dl4ss_tpu_torch.train.state import create_train_state
    cfg_j = jax_preset("cocktail_debug").replace(**SMALL)
    cfg_t = preset("cocktail_debug").replace(**SMALL)
    ref = jax_state(jax.random.PRNGKey(0), cfg_j, with_memory=True).memory
    state = create_train_state(cfg_t, device="cpu", with_memory=True)
    assert state.memory.vectors.shape == ref.vectors.shape == (7, 3, 8)
    for ours, want in zip(state.memory, ref):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(want))
        assert ours.numpy().dtype == np.asarray(want).dtype
    assert create_train_state(cfg_t, device="cpu").memory is None
    state.memory = tmem.memory_write(state.memory, torch.tensor([2]),
                                     torch.ones((1, 8)))
    save_checkpoint(str(tmp_path), state)
    back = restore_checkpoint(str(tmp_path), create_train_state(
        cfg_t, seed=9, device="cpu", with_memory=True))
    assert all(torch.equal(a, b) for a, b in zip(back.memory, state.memory))


def test_memory_reset_extend_and_converter_match_jax():
    rng = np.random.default_rng(1)
    vec, age = _random_memory(rng)
    ref = jmem.MemorySlots(jnp.asarray(vec), jnp.asarray(age))
    ours = tmem.memory_from_jax(ref)
    assert ours.vectors.dtype == torch.float32
    assert ours.age.dtype == torch.int32
    rows = np.array([0, 3], np.int32)
    ref = jmem.memory_extend(jmem.memory_reset_rows(ref, jnp.asarray(rows)),
                             2)
    ours = tmem.memory_extend(tmem.memory_reset_rows(ours,
                                                     torch.as_tensor(rows)), 2)
    np.testing.assert_allclose(ours.vectors.numpy(), np.asarray(ref.vectors),
                               atol=1e-6)
    np.testing.assert_array_equal(ours.age.numpy(), np.asarray(ref.age))
    assert ours.vectors.shape == (7, 3, 4) and ours.age.dtype == torch.int32


def test_memory_write_passes_the_gradient_to_the_incoming_vectors():
    """d(sum of the read rows * w)/d(vec) through the in-graph write,
    against jax.grad: 1e-6."""
    rng = np.random.default_rng(2)
    vec, age = _random_memory(rng)
    spk = np.array([0, 2, 0], np.int32)
    incoming = rng.standard_normal((3, 4)).astype(np.float32)
    w = rng.standard_normal((3, 4)).astype(np.float32)

    def jax_loss(v):
        mem = jmem.memory_write_slot(jmem.MemorySlots(jnp.asarray(vec),
                                                      jnp.asarray(age)),
                                     jnp.asarray(spk), v)
        return jnp.sum(jmem.memory_read(mem, jnp.asarray(spk)) * w)

    ref = jax.grad(jax_loss)(jnp.asarray(incoming))
    v = torch.as_tensor(incoming).requires_grad_()
    mem = tmem.memory_write_slot(tmem.MemorySlots(torch.as_tensor(vec),
                                                  torch.as_tensor(age)),
                                 torch.as_tensor(spk), v)
    (tmem.memory_read(mem, torch.as_tensor(spk))
     * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(ref), atol=1e-6)


def test_linear_target_mags_match_jax_with_log_features():
    """The linear magnitudes equal JAX's to within the f32 summation of the
    DFT: each bin is a sum over a frame, and the two sides sum it in
    another order (the CPU's BLAS picks it), so they differ by a few ulps
    of the spectrum's peak (at most 6.7e-7 of it over seeds 0-5; peaks of
    37-66). The bound is 2e-6 of the peak, three times that; a wrong
    window or a missing frame is O(1) off."""
    cfg_j = jax_preset("cocktail_debug").replace(log_spectral=True,
                                                 window="sine", **SMALL)
    cfg_t = preset("cocktail_debug").replace(log_spectral=True,
                                             window="sine", **SMALL)
    bank = jnp.asarray(jax_bank(3, cfg_j.num_speakers, 2, cfg_j.max_len))
    b = jax_sample(jax.random.PRNGKey(3), bank, cfg_j)
    f = jax_featurize(b, cfg_j)
    ref = jax_target_mags(f, b, cfg_j)
    batch = MixtureBatch(*(torch.as_tensor(np.array(x)) for x in b))
    ours = linear_target_mags({"mix_ri": torch.as_tensor(
        np.array(f["mix_ri"]))}, batch, cfg_t)
    for a, r in zip(ours, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(a.numpy(), r,
                                   atol=2e-6 * np.abs(r).max())


def _float64_grads(cfg_t, state_t, feats, query_source):
    """The gradients of the port's step from a float64 copy of its state
    and batch."""
    state = copy.deepcopy(state_t)
    state.model.double()
    state.memory = tmem.MemorySlots(state.memory.vectors.double(),
                                    state.memory.age)
    state.opt_state.mu = [m.double() for m in state.opt_state.mu]
    state.opt_state.nu = [v.double() for v in state.opt_state.nu]
    feats = {k: torch.as_tensor(v.astype(np.float64) if v.dtype ==
                                np.float32 else v) for k, v in feats.items()}
    return torch_step(lambda: tmt.make_memory_train_step(cfg_t,
                                                         query_source),
                      state, feats)[1]


@pytest.mark.parametrize("query_source,over", [
    ("speech", {}), ("image", {}), ("speech", {"loss_mode": "si_sdr"})],
    ids=["speech", "image", "speech_si_sdr"])
def test_memory_train_step_matches_jax(query_source, over):
    """One memory train step from the same parameters, memory and batch
    (a duplicate target in it), seed 0: the loss and grad norm within 1e-5,
    every leaf's gradient within 1e-5 relative L2, every update within
    1e-3 relative L2 on the elements outside the round-off band
    (tests/torch_step_parity.py), the memory after the out-of-graph write
    within 1e-5 and its ages equal.

    Under loss_mode='si_sdr' the speech query's gradients reach JAX through
    its f32 reductions over the resynthesised waveforms, which leave them
    up to ~2e-5 from the same step in float64; there each gradient is held
    to 1e-5 of the port's float64 step instead, and the updates to JAX's
    as above."""
    cfg_j, state_j, cfg_t, state_t = _state(query_source=query_source,
                                            **over)
    feats = _feats(cfg_j, query_source=query_source)
    grads_64 = (_float64_grads(cfg_t, state_t, feats, query_source)
                if over.get("loss_mode") == "si_sdr" else None)
    before = dict(flatten_tree(_np_tree(state_j.params)))
    (new_j, met_j), grads_j = jax_step(
        jmt, lambda: jmt.make_memory_train_step(cfg_j, query_source),
        state_j, {k: jnp.asarray(v) for k, v in feats.items()})
    (new_t, met_t), grads_t = torch_step(
        lambda: tmt.make_memory_train_step(cfg_t, query_source), state_t,
        _t(feats))
    assert new_t.step == 1
    for key in ("loss", "grad_norm"):
        assert abs(float(met_t[key]) - float(met_j[key])) \
            <= 1e-5 * abs(float(met_j[key])), key
    assert_step_matches(before, new_j.params, new_t.model, grads_j, grads_t,
                        grads_ref=grads_64)
    np.testing.assert_allclose(new_t.memory.vectors.numpy(),
                               np.asarray(new_j.memory.vectors), atol=1e-5)
    np.testing.assert_array_equal(new_t.memory.age.numpy(),
                                  np.asarray(new_j.memory.age))


def test_memory_step_opens_forward_backward_optimizer():
    """The memory step's phases under the profiler: its forward (the
    voiceprint, the in-graph write and the align head inside it),
    backward and optimizer, each once, and the persistent write after
    the update, outside the forward."""
    from torch.profiler import ProfilerActivity, profile
    cfg_j, _, cfg_t, state_t = _state()
    feats = _t(_feats(cfg_j))
    step = tmt.make_memory_train_step(cfg_t)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state_t, feats)
    spans = sorted((e.time_range.start, e.time_range.end, e.name[6:])
                   for e in prof.events() if e.name.startswith("dl4ss."))
    assert sorted(n for _, _, n in spans) == [
        "align_head", "backward", "forward", "memory_write", "memory_write",
        "optimizer", "voiceprint"]
    (f0, f1), = [(s, t) for s, t, n in spans if n == "forward"]
    inside = {n for s, t, n in spans if f0 <= s and t <= f1 and n != "forward"}
    assert inside == {"voiceprint", "memory_write", "align_head"}
    opt_end = max(t for _, t, n in spans if n == "optimizer")
    assert spans[-1][2] == "memory_write" and spans[-1][0] >= opt_end


@pytest.mark.parametrize("mode", ["keras", "torch"])
@pytest.mark.parametrize("spk", [[2, 1, 2, 4], [3, 3, 3, 0], [4, 4, 4, 4]],
                         ids=["one-duplicate", "three-duplicates", "one-row"])
def test_write_counts_equal_bincount(mode, spk):
    """The write counts come from the one-hot's column sums (no host
    sync on the card): the ages grow by exactly `bincount` of the ids,
    with duplicates and with rows the batch leaves unused, in the written
    slot alone."""
    rng = np.random.default_rng(1)
    vec, age = _random_memory(rng)
    ids = torch.tensor(spk)
    incoming = torch.as_tensor(rng.standard_normal((len(spk), 4)),
                               dtype=torch.float32)
    out = tmem.memory_write_slot(
        tmem.MemorySlots(torch.as_tensor(vec), torch.as_tensor(age)), ids,
        incoming, tmem.SLOT_VIDEO, mode)
    want = torch.as_tensor(age).clone()
    want[:, tmem.SLOT_VIDEO] += torch.bincount(ids, minlength=5).to(
        torch.int32)
    assert out.age.dtype == torch.int32
    assert torch.equal(out.age, want)
    unused = torch.bincount(ids, minlength=5) == 0
    if mode == "torch":       # only touched rows change in this mode
        assert torch.equal(out.vectors[unused], torch.as_tensor(vec)[unused])


def test_memory_eval_step_and_enroll_match_jax():
    """After one train step (a non-empty memory): the eval step's masks,
    predictions and loss, and `enroll` of two clean utterances into the
    reserved unk row and a fresh row, within 1e-5. The predictions are
    mask times the linear mixture spectrum (peaks near 30), which the two
    sides sum in another f32 order: they are held to 2e-6 of their peak
    (the same bound as the linear target magnitudes), not to 1e-5, a
    couple of ulps there."""
    cfg_j, state_j, cfg_t, state_t = _state(seed=3)
    feats = _feats(cfg_j, seed=4)
    state_j, _ = jmt.make_memory_train_step(cfg_j)(
        state_j, {k: jnp.asarray(v) for k, v in feats.items()})
    state_t, _ = tmt.make_memory_train_step(cfg_t)(state_t, _t(feats))
    ref = jmt.make_memory_eval_step(cfg_j)(
        state_j.params, state_j.memory,
        {k: jnp.asarray(v) for k, v in feats.items()})
    ours = tmt.make_memory_eval_step(cfg_t)(state_t.model, state_t.memory,
                                            _t(feats))
    for key in ("pred_mag", "mask", "loss"):
        r = np.asarray(ref[key])
        atol = 2e-6 * np.abs(r).max() if key == "pred_mag" else 1e-5
        np.testing.assert_allclose(ours[key].numpy(), r, atol=atol,
                                   err_msg=key)
    rows = np.array([jmt.unk_row(cfg_j), cfg_j.num_speakers + 1], np.int32)
    assert tmt.unk_row(cfg_t) == rows[0]
    ref = jmt.enroll(state_j.params, jmem.memory_extend(state_j.memory, 1),
                     cfg_j, jnp.asarray(rows),
                     jnp.asarray(feats["clean_feas"][:2]))
    ours = tmt.enroll(state_t.model, tmem.memory_extend(state_t.memory, 1),
                      cfg_t, torch.as_tensor(rows),
                      torch.as_tensor(feats["clean_feas"][:2]))
    np.testing.assert_allclose(ours.vectors.numpy(), np.asarray(ref.vectors),
                               atol=1e-5)
    np.testing.assert_array_equal(ours.age.numpy(), np.asarray(ref.age))


def test_early_stop_matches_jax_and_restores_the_best(monkeypatch):
    """Both loops on the same scripted dev losses (the eval step replaced
    in each package): they stop after the same epoch, with patience 2, and
    the port ends on the parameters and memory of its best epoch, copies
    taken then (not references the optimizer moved on)."""
    script = [5.0, 4.0, 4.5, 3.0, 3.5, 3.2, 3.1, 2.0]
    cfg_j, _, cfg_t, _ = _state()

    def scripted(seen):
        def make(cfg, query_source="speech"):
            def step(params, memory, feats):
                seen.append((params, memory))
                return {"loss": script[len(seen) - 1]}
            return step
        return make

    seen_j, seen_t = [], []
    monkeypatch.setattr(jmt, "make_memory_eval_step", scripted(seen_j))
    monkeypatch.setattr(tmt, "make_memory_eval_step", scripted(seen_t))
    feats = _feats(cfg_j)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    _, hist_j = jmt.memory_train_loop(cfg_j, lambda key: jfeats,
                                      max_epochs=len(script), epoch_size=1,
                                      patience=2, dev_batch=jfeats)
    snapshots = []

    def make_batch(generator):
        return _t(feats)

    real = tmt._snapshot

    def snapshot(state):
        snapshots.append(real(state))
        return snapshots[-1]

    monkeypatch.setattr(tmt, "_snapshot", snapshot)
    state, hist_t = tmt.memory_train_loop(
        cfg_t, make_batch, max_epochs=len(script), epoch_size=1, patience=2,
        dev_batch=_t(feats), device="cpu")
    assert hist_t == hist_j == script[:6]
    assert state.step == 6 and len(snapshots) == 3    # epochs 0, 1, 3
    best_params, best_memory = snapshots[-1]
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, best_params[k]), k
    assert torch.equal(state.memory.vectors, best_memory.vectors)
    # the copies were taken at epoch 3: the two steps after it moved on
    assert not torch.equal(best_memory.age, seen_t[-1][1].age)


# ---- the CLIs -------------------------------------------------------------

CLI = ["--preset", "cocktail", "--device", "cpu", "--seed", "0",
       "--set", "hidden_units=16", "--set", "embedding_size=6",
       "--set", "max_len_seconds=0.25", "--set", "batch_size=2",
       "--set", "batch_size_eval=2", "--set", "num_layers=1",
       "--set", "encoder_layers=1", "--set", "learning_rate=0.003"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two rehearsal corpora (5 and 3 speakers, 0.25 s) and the Cocktail
    wavlists over them (the second corpus is the unk split)."""
    root = tmp_path_factory.mktemp("cocktail")
    generate_corpus(str(root / "a"), n_spk=5, utts=5, seconds=0.25,
                    tr_entries=4, cv_entries=2, tt_entries=2, cv_holdout=1)
    generate_corpus(str(root / "b"), n_spk=3, utts=3, seconds=0.25,
                    tr_entries=4, cv_entries=2, tt_entries=2, cv_holdout=1,
                    seed=7)
    cocktail_layout(str(root / "a"), str(root / "ct"), 2, str(root / "b"))
    generate_file_lists(str(root / "ct"), str(root / "lists"))
    return root


def _tree(corpus):
    return ["--data-root", str(corpus / "a" / "wsj0"), "--split",
            "si_tr_s", "--utts", "3"]


def _train(*argv):
    from dl4ss_tpu_torch.run import train
    return train.main([*CLI, "--mode", "memory", *argv])


def test_train_cli_memory_on_a_tree_writes_vocab_and_resumes(tmp_path,
                                                             corpus):
    """run.train --mode memory on a speaker tree: the checkpoint holds the
    memory, vocab.json maps the tree's speakers to memory rows (as the JAX
    CLI writes it), and 1 epoch + --resume 1 equals 2 unbroken epochs bit
    for bit (the saved state after one epoch is its best and its last)."""
    ck = tmp_path / "ck"
    tree = _tree(corpus)
    _train(*tree, "--epochs", "1", "--epoch-size", "2", "--checkpoint-dir",
           str(ck))
    vocab = json.loads((ck / "vocab.json").read_text())
    assert vocab == {s: i for i, s in enumerate(sorted(os.listdir(
        corpus / "a" / "wsj0" / "si_tr_s")))}
    payload = torch.load(ck / "step_2.pt", weights_only=True)
    assert payload["memory"]["vectors"].shape == (6, 3, 6)
    m_res, m_unb = tmp_path / "r.jsonl", tmp_path / "u.jsonl"
    resumed = _train(*tree, "--epochs", "2", "--epoch-size", "2",
                     "--checkpoint-dir", str(ck), "--resume", "--metrics",
                     str(m_res))
    unbroken = _train(*tree, "--epochs", "2", "--epoch-size", "2",
                      "--metrics", str(m_unb))
    hist = [json.loads(x)["dev_loss"]
            for x in m_unb.read_text().splitlines()]
    assert hist[1] < hist[0], hist
    assert resumed.step == unbroken.step == 4
    for a, b in zip(resumed.model.state_dict().values(),
                    unbroken.model.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(resumed.opt_state.mu + resumed.opt_state.nu,
                    unbroken.opt_state.mu + unbroken.opt_state.nu):
        assert torch.equal(a, b)
    assert torch.equal(resumed.memory.vectors, unbroken.memory.vectors)
    assert torch.equal(resumed.memory.age, unbroken.memory.age)


def test_train_cli_init_from_carries_the_memory(tmp_path, corpus):
    """--init-from: the donor's parameters AND memory rows, a fresh
    optimizer and step 0 before training."""
    ck, ck2 = tmp_path / "ck", tmp_path / "ck2"
    donor = _train(*_tree(corpus), "--epochs", "1", "--epoch-size", "1",
                   "--checkpoint-dir", str(ck))
    warm = _train(*_tree(corpus), "--epochs", "1", "--epoch-size", "0",
                  "--init-from", str(ck), "--checkpoint-dir", str(ck2))
    assert warm.step == 0 and warm.opt_state.count == 0
    assert torch.equal(warm.memory.vectors, donor.memory.vectors)
    assert torch.any(warm.memory.vectors != 0)
    for a, b in zip(warm.model.state_dict().values(),
                    donor.model.state_dict().values()):
        assert torch.equal(a, b)


def test_memory_clis_on_the_cocktail_wavlists(tmp_path, corpus, capsys):
    """run.train --file-lists builds its bank from train_wavlist.txt and
    writes the list vocabulary; run.evaluate --file-lists scores the test
    list and the unk list (each unknown speaker enrolled from the
    supplemental column first)."""
    from dl4ss_tpu_torch.run import evaluate
    ck = tmp_path / "ck"
    lists = str(corpus / "lists")
    _train("--file-lists", lists, "--epochs", "1", "--epoch-size", "1",
           "--checkpoint-dir", str(ck))
    assert json.loads((ck / "vocab.json").read_text()) == {
        s: i for i, s in enumerate(sorted(os.listdir(corpus / "ct" /
                                                     "train")))}
    test = evaluate.main([*CLI, "--mode", "memory", "--checkpoint-dir",
                          str(ck), "--file-lists", lists, "--split", "test"])
    unk = evaluate.main([*CLI, "--mode", "memory", "--checkpoint-dir",
                         str(ck), "--file-lists", lists, "--split", "unk"])
    out = capsys.readouterr().out
    assert "enrolled 3 unknown speakers" in out
    assert test["n"] == 5 and unk["n"] == 9
    assert np.isfinite([test["si_sdr"], unk["si_sdr"], unk["nsdr"],
                        *unk["gain"].values()]).all()


@pytest.mark.parametrize("unk", ["holdout", "root"])
def test_evaluate_cli_memory_with_unknown_speakers(tmp_path, corpus, unk):
    """run.evaluate --mode memory: known speakers, then unknown ones, the
    last 2 tree speakers (--unk-holdout) or a second corpus (--unk-root),
    each enrolled into its own row (the reserved unk row first)."""
    from dl4ss_tpu_torch.run import evaluate
    ck = tmp_path / "ck"
    tree = _tree(corpus)
    _train(*tree, "--epochs", "1", "--epoch-size", "1", "--checkpoint-dir",
           str(ck))
    known = evaluate.main([*CLI, "--mode", "memory", "--checkpoint-dir",
                           str(ck), *tree, "--batches", "1"])
    extra = (["--unk-holdout", "2"] if unk == "holdout" else
             ["--unk-root", str(corpus / "b" / "wsj0")])
    res = evaluate.main([*CLI, "--mode", "memory", "--checkpoint-dir",
                         str(ck), *tree, "--enroll-seconds", "0.1", *extra])
    assert res["n_unk"] == (2 if unk == "holdout" else 3)
    assert np.isfinite([known["si_sdr"], res["si_sdr"], res["nsdr"],
                        *res["gain"].values()]).all()
