"""The benchmark's two list-and-waveform cells at small sizes on the CPU:
`dprnn_tasnet.train_b4` (DPRNN-TasNet against `reference/dprnn.py`) and
`tdaa.train_list` (TDAA's adversarial step fed from the wsj0-2mix lists
of a rehearsal corpus, against `reference/lists.py`). Their files and
manifest entries, their step counts, each run whole through the harness
reading `correct`, and a planted fault in each caught: the inter-chunk
path skipped, and the list batches mixed with the wrong gains."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.harness import registry  # noqa: E402
from benchmark.harness.program import reference_config  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_math_thread():
    """Tiny shapes: one host thread for the CPU's math, so that on a
    machine busy with other processes its threads do not wait on each
    other (tens of times slower there)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
CELLS = {"dprnn_tasnet.train_b4": ("dprnn_tasnet", "train_tasnet_b4",
                                   "train_tasnet"),
         "tdaa.train_list": ("tdaa", "train_list_b16", "train_list")}
SMALL = {
    "dprnn_tasnet.train_b4": (
        {"config": {"max_len_seconds": 0.05, "batch_size": 2,
                    "num_speakers": 6},
         "derived": {"max_len": 400, "num_frames": 4},
         "model": {"filters": 8, "bottleneck": 8, "hidden": 8, "blocks": 2,
                   "chunk": 6, "hop": 3}},
        {"batch": 2, "warmup_units": 1, "trace_units": 1,
         "bank": {"utterances": 3}}),
    # 4 speakers x 3 utterances and 8 list entries: two batches an epoch,
    # so the three compared steps cross an epoch's end
    "tdaa.train_list": (
        {"config": {"hidden_units": 8, "embedding_size": 4,
                    "max_len_seconds": 0.25, "batch_size": 4},
         "derived": {"max_len": 2000, "num_frames": 16}},
        {"batch": 4, "warmup_units": 1, "trace_units": 1,
         "corpus": {"speakers": 4, "utterances": 3, "seconds": 0.25,
                    "train_entries": 8, "valid_entries": 0,
                    "test_entries": 0, "db_range": 2.5, "holdout": 1,
                    "seed": 1}}),
}


def run_small(cell: str) -> dict:
    from benchmark.run import execute
    config, traffic = SMALL[cell]
    return execute(cell, 2 ** 33 + 17, 1.0, False, CPU, registry.manifest(),
                   config, traffic)["result"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_files_and_manifest_entries(cell):
    """The manifest's entry names the cell file's configuration and
    traffic, one chip; the cell reports the training cells' metrics; a step
    counts products and the recurrence of each layer's launch."""
    man = registry.manifest()
    entry, cell_file, config, traffic = registry.load_cell(man, cell)
    want = CELLS[cell]
    assert (entry["config"], entry["traffic"], cell_file["driver"]) == want
    assert entry["chips"] == 1 and config["reduced"] == []
    listed = {m["name"] for m in man["per_layer"] + man["end_to_end"]
              if cell in m.get("workloads", [cell])}
    assert listed == {"train_mix_per_s", "setup_s", "mfu.train",
                      "rnn_roofline_pct.train", "idle_pct.train",
                      "launches.train"}
    count = registry.load_module("drivers", want[2]).count(
        registry.load_module("flops", want[0]), reference_config(config),
        traffic["batch"])
    assert count.model > 0
    # 12 BiLSTM layers forward and backward; tdaa's 4 encoder layers in
    # phase 1's forward, phase 2's forward and its backward
    assert len(count.recurrence) == {"dprnn_tasnet": 24, "tdaa": 12}[
        want[0]]


def test_dprnn_count_of_a_step():
    """A B=4 step at the published widths: each intra layer's U.h products
    over 1,028 rows x 250 steps, each inter layer's over 1,000 x 257, and
    the forward three times over."""
    c = reference_config(registry.load_json("configs", "dprnn_tasnet"))
    fwd = registry.load_module("flops", "dprnn_tasnet").dprnn(c, 4)
    assert [o for o, _ in fwd.recurrence[:2]] == [
        2 * 2 * 1028 * 250 * 128 * 512, 2 * 2 * 1000 * 257 * 128 * 512]
    count = registry.load_module("drivers", "train_tasnet").count(
        registry.load_module("flops", "dprnn_tasnet"), c, 4)
    assert count.model == pytest.approx(3 * fwd.model)
    assert 3.0e12 < count.model < 5.0e12


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    res = run_small(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["checks"]) == {"loss1_gap", "loss_gap", "grad_gap",
                                  "grad_diff", "change_gap",
                                  "window_loss_gap"}


def _skip_inter(monkeypatch):
    """Every second dual-path half (each block's inter-chunk BiLSTM)
    left out: the residual passes its input on."""
    from dl4ss_tpu_torch.models import dprnn
    real, calls = dprnn._path, [0]

    def path(p, x, use_pallas):
        calls[0] += 1
        return x if calls[0] % 2 == 0 else real(p, x, use_pallas)

    monkeypatch.setattr(dprnn, "_path", path)


def _wrong_gains(monkeypatch):
    """The list batches mixed at the negated dB gains."""
    from dl4ss_tpu_torch.data import listsampler
    real = listsampler.mix_from_list
    monkeypatch.setattr(
        listsampler, "mix_from_list",
        lambda bank, utt_idx, gains_db, spk_idx, cfg, live=None,
        shifts=None: real(bank, utt_idx, -gains_db, spk_idx, cfg, live,
                          shifts))


@pytest.mark.parametrize("cell,fault", [
    ("dprnn_tasnet.train_b4", _skip_inter),
    ("tdaa.train_list", _wrong_gains)], ids=["inter_skipped", "wrong_gains"])
def test_planted_fault_is_caught(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = run_small(cell)
    assert not res["correct"]
    failing = {k for k, v in res["checks"].items()
               if not v["value"] <= v["limit"]}
    assert {"loss1_gap", "grad_diff"} <= failing, res["checks"]
