"""Each fault a cell can have, planted under the timed path, turns
`correct` false: the rest of a run (set-up, window, reference, result)
runs as usual, on the CPU at a small size, skipping only the look for a
card. One cell exchanges nothing between chips, so that fault has no
case here."""

from __future__ import annotations

import pytest
import torch

from conftest import run_tiny

TRAIN_CELLS = ("torch_multi.train_b16", "tdaa.train_adv_b16")
SERVE_CELLS = ("torch_multi.serve_b1", "tdaa.serve_select_b16")


@pytest.mark.parametrize("cell", TRAIN_CELLS + SERVE_CELLS)
def test_sound_run_is_correct(cell):
    res = run_tiny(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_state_left_unchanged_is_caught(cell, monkeypatch):
    from dl4ss_tpu_torch.train import state as st

    def no_update(self, params, grads, state, norm=None):
        return st.global_norm(grads)

    monkeypatch.setattr(st.Optimizer, "update", no_update)
    res = run_tiny(cell)
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] > 0.99


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_half_batch_left_out_is_caught(cell, monkeypatch):
    from dl4ss_tpu_torch.data import synth
    from dl4ss_tpu_torch.train import steps

    real = synth.featurize

    def half(batch, cfg):
        keep = batch.mix_wav.shape[0] // 2
        return real(type(batch)(*(None if x is None else x[:keep]
                                  for x in batch)), cfg)

    monkeypatch.setattr(synth, "featurize", half)
    monkeypatch.setattr(steps, "featurize", half)
    res = run_tiny(cell)
    assert not res["correct"]
    assert not all(c["value"] <= c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_fault_that_starts_after_warm_up_is_caught(cell, monkeypatch):
    """Half of the batch left out only from the fifth step on (past the
    three compared steps and the warm-up): the step after the window
    catches it."""
    from dl4ss_tpu_torch.data import synth
    from dl4ss_tpu_torch.train import steps

    real, calls = synth.featurize, []

    def late_half(batch, cfg):
        calls.append(1)
        if len(calls) <= 4:
            return real(batch, cfg)
        keep = batch.mix_wav.shape[0] // 2
        return real(type(batch)(*(None if x is None else x[:keep]
                                  for x in batch)), cfg)

    monkeypatch.setattr(synth, "featurize", late_half)
    monkeypatch.setattr(steps, "featurize", late_half)
    res = run_tiny(cell)
    assert not res["correct"]
    failing = [k for k, c in res["checks"].items()
               if not c["value"] <= c["limit"]]
    assert failing == ["window_loss_gap"], res["checks"]


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_altered_answer_is_caught(cell, monkeypatch):
    from dl4ss_tpu_torch import serve

    real = serve.masked_resynthesis

    def altered(*args, **kwargs):
        return real(*args, **kwargs) * 1.01

    monkeypatch.setattr(serve, "masked_resynthesis", altered)
    res = run_tiny(cell)
    assert not res["correct"]
    assert res["checks"]["wave_err"]["value"] > 5e-3


def test_wrong_pick_is_caught(monkeypatch):
    from dl4ss_tpu_torch import serve

    def second_and_third(probs, k):
        vals, idx = torch.topk(probs, k + 1, dim=-1)
        return idx[:, 1:], vals[:, 1:]

    monkeypatch.setattr(serve, "top_k_indices", second_and_third)
    res = run_tiny("tdaa.serve_select_b16")
    assert not res["correct"]
    assert res["checks"]["wave_err"]["value"] == 1.0
