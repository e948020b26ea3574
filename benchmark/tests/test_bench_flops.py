"""The FLOP counts against shapes worked by hand, at the cells' sizes."""

from __future__ import annotations

import math

import pytest

from benchmark.harness import registry
from benchmark.harness.program import reference_config


def _count(config, driver, batch):
    c = reference_config(registry.load_json("configs", config))
    return registry.load_module("drivers", driver).count(
        registry.load_module("flops", config), c, batch)


def _rfft(frames):
    return frames * 2.5 * 256 * math.log2(256)


def test_torch_multi_joint_step():
    b, t = 16, 313
    gru0 = 2 * 2 * b * t * (129 + 300) * 900          # inputs + U, 2 dirs
    gru1 = 2 * 2 * b * t * (600 + 300) * 900
    proj = 2 * b * t * 600 * 6450
    head = 2 * b * 2 * t * 129 * 50
    want = _rfft(b * t * 3) + 3 * (gru0 + gru1 + proj + head)
    got = _count("torch_multi", "train_joint", b)
    assert got.model == pytest.approx(want, rel=1e-12)
    assert got.model == pytest.approx(1.89e11, rel=0.01)
    u = 2 * 2 * b * t * 300 * 900
    assert [o for o, _ in got.recurrence] == [u, u, 2 * u, 2 * u]


def test_torch_multi_request_is_bytes_bound():
    got = _count("torch_multi", "serve_given", 1)
    u_ops, nbytes = got.recurrence[0]
    assert u_ops == 2 * 2 * 313 * 300 * 900
    # U and the projected inputs of both directions in f32, h written
    assert nbytes == 4 * 2 * (300 * 900 + 313 * 900) + 4 * 2 * 313 * 300
    assert nbytes / 3.35e12 > u_ops / 495e12


def test_tdaa_selecting_batch():
    b, t = 16, 313
    enc = (2 * 2 * b * t * (129 + 300) * 1200
           + 3 * 2 * 2 * b * t * (600 + 300) * 1200)
    cls = (2 * 2 * b * t * (129 + 600) * 2400
           + 2 * 2 * b * t * (1200 + 600) * 2400 + 2 * b * 1200 * 103)
    sep = (enc + 2 * b * t * 600 * 6450 + 2 * b * 2 * t * 129 * 50
           + 2 * b * 2 * 650 * 50)
    want = _rfft(b * t * 3) + sep + cls
    got = _count("tdaa", "serve_select", b)
    assert got.model == pytest.approx(want, rel=1e-12)
    assert got.model == pytest.approx(2.36e11, rel=0.02)
    assert len(got.recurrence) == 6


def test_tdaa_adversarial_step():
    b, t = 16, 313
    conv = (2 * 156 * 64 * 64 * 9 + 2 * 77 * 31 * 64 * 576
            + 2 * 38 * 15 * 64 * 576 + 2 * 38 * 15 * 64)
    sep = _count("tdaa", "serve_given", b).model - _rfft(b * t * 3)
    got = _count("tdaa", "train_adversarial", b)
    want = _rfft(b * t * 3) + sep + 3 * 64 * conv + 3 * sep + 2 * 32 * conv
    assert got.model == pytest.approx(want, rel=1e-12)
    assert len(got.recurrence) == 4 + 4 + 4


def test_a_driver_needs_the_layers_it_counts():
    # torch_multi has no discriminator, so no adversarial step to count
    with pytest.raises(AttributeError):
        _count("torch_multi", "train_adversarial", 16)
