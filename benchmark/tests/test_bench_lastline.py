"""A run's last line: its keys, the numbers compared beside their limits,
and no result at all without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import REPO, run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(trace):
    res = run_tiny("torch_multi.serve_b1", trace=trace)
    want = KEYS[:5] + (["breakdown"] if trace else []) + ["checks"]
    assert list(res) == want
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == {"serve_mix_per_s", "serve_p95_ms",
                                       "setup_s"}
        assert all(set(v) == {"value", "unit"}
                   for v in res["metrics"].values())
    assert all(set(v) == {"value", "limit"} for v in res["checks"].values())
    json.dumps(res)


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "torch_multi.serve_b1", "--seed", str(2 ** 31 + 5), "--seconds",
         "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
        timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()
