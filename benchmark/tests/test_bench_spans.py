"""The reduction of the program's phase spans (`harness/spans.py`): on
synthetic slices, and on tiny traced runs of every cell on the CPU."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.harness import spans, trace, window
from benchmark.harness.trace import Slice
from benchmark.phases import per_unit, with_spans
from conftest import run_tiny

US = 1e-6


def _slice(device=(), host=(), start=0.0, end=100.0, units=1):
    return Slice(start, end, units, list(device), list(host))


NESTED = _slice(
    device=[("k1", 10, 20), ("k2", 60, 70)],
    host=[("dl4ss.forward", 5, 80), ("dl4ss.sample", 30, 50),
          ("aten::mm", 35, 40)])


def test_idle_time_is_split_by_exact_intersection():
    """Idle [0,10) [20,60) [70,100): forward holds [5,10) [20,30) [50,60)
    [70,80); the sample span inside it takes [30,50); an aten op is no
    phase; the rest is outside."""
    red = spans.reduce([NESTED])
    assert red["idle_s"] == pytest.approx(
        {"forward": 35 * US, "sample": 20 * US, "outside": 25 * US})
    assert red["units"] == 1 and red["window_s"] == pytest.approx(100 * US)


def test_the_latest_start_wins_across_threads():
    """Two spans that overlap without nesting (another thread's): the one
    that started later takes the overlap; equal starts go to the one that
    ends first."""
    red = spans.reduce([_slice(host=[
        ("dl4ss.backward", 0, 50), ("dl4ss.optimizer", 40, 90),
        ("dl4ss.forward", 90, 95), ("dl4ss.sample", 90, 92)])])
    assert red["idle_s"] == pytest.approx(
        {"backward": 40 * US, "optimizer": 50 * US, "sample": 2 * US,
         "forward": 3 * US, "outside": 5 * US})


def test_idle_time_under_no_span_is_outside():
    red = spans.reduce([_slice(device=[("k", 20, 30)])])
    assert red["idle_s"] == pytest.approx({"outside": 90 * US})
    assert red["syncs"] == {}


@pytest.mark.parametrize("seed", range(4))
def test_phases_and_outside_sum_to_the_idle_time(seed):
    """On random slices (overlapping kernels, kernels past the slice's
    end, nested and overlapping spans, spans past its edges) the idle
    seconds sum to what `trace.summarize` reads: window less busy."""
    rng = np.random.default_rng(seed)
    slices = []
    for k in range(3):
        lo = 1000.0 * k
        dev = [("k", s, s + d) for s, d in zip(
            rng.uniform(lo, lo + 900, 40), rng.exponential(15, 40))]
        host = [(f"dl4ss.p{i % 5}", s, s + d) for i, (s, d) in enumerate(zip(
            rng.uniform(lo - 50, lo + 900, 12), rng.exponential(200, 12)))]
        slices.append(Slice(lo, lo + 900, 2, dev, host))
    red = spans.reduce(slices)
    summary = trace.summarize(slices)
    assert sum(red["idle_s"].values()) == pytest.approx(
        summary["window_s"] - summary["busy_s"], rel=1e-9)
    assert red["window_s"] == pytest.approx(summary["window_s"])
    assert red["units"] == summary["units"] == 6


def test_syncs_are_counted_inside_spans_only():
    sl = NESTED._replace(host=NESTED.host + [
        ("cudaStreamSynchronize", 7, 9), ("cudaStreamSynchronize", 32, 33),
        ("cudaEventSynchronize", 55, 56), ("cudaLaunchKernel", 6, 7),
        ("cudaStreamSynchronize", 90, 91), ("cudaDeviceSynchronize", 95, 99),
        ("cudaStreamSynchronize", -5, 1)])
    assert spans.reduce([sl])["syncs"] == {"forward": 2, "sample": 1}


def test_a_phase_is_listed_once_its_span_opened():
    """A span over busy time alone reads 0.0 s and 0 syncs; one that
    never opened in a slice (or only before it) is not listed."""
    red = spans.reduce([_slice(device=[("k", 10, 20)], host=[
        ("dl4ss.backward", 12, 18), ("dl4ss.optimizer", -20, -10)])])
    assert red["idle_s"]["backward"] == 0.0
    assert red["syncs"] == {"backward": 0}
    assert "optimizer" not in red["idle_s"]


def test_per_unit():
    out = per_unit(spans.reduce([NESTED._replace(units=5)]))
    assert out["idle_ms"]["sample"] == pytest.approx(20 * US * 1e3 / 5)
    assert out["idle_ms_total"] == pytest.approx(80 * US * 1e3 / 5)
    assert out["window_ms"] == pytest.approx(100 * US * 1e3 / 5)


TRAIN = {"sample", "featurize", "forward", "backward", "optimizer"}
SERVE = {"features", "separate", "resynthesis"}


@pytest.mark.parametrize("cell, phases", [
    ("torch_multi.train_b16", TRAIN), ("tdaa.train_adv_b16", TRAIN),
    ("torch_multi.serve_b1", SERVE), ("tdaa.serve_select_b16", SERVE)])
def test_a_traced_run_sees_the_cells_phases(cell, phases, monkeypatch):
    """A tiny traced run on the CPU: every phase of the cell's unit opens
    in its slice (no device, so all of the window is idle). The slice
    starts with the window, so that a loaded host cannot end the window
    before it."""
    monkeypatch.setattr(window, "TRACE_AT", (0.0,))
    res, red = with_spans(lambda: run_tiny(cell, trace=True))
    assert res["correct"] and red["units"] > 0
    assert set(red["idle_s"]) == phases | {"outside"}
    assert set(red["syncs"]) == phases
    assert sum(red["idle_s"].values()) == pytest.approx(red["window_s"])
