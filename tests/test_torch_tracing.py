"""The phase spans of the port's steps and requests (`utils.profiling.span`).

Outside a profiler a span is one shared no-op context; under
`torch.profiler` each opens one `dl4ss.<phase>` host event where the
phase's work happens, once per phase of every trainer and serving program.
"""

from __future__ import annotations

import collections
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dl4ss_tpu_torch.config import preset
from dl4ss_tpu_torch.data.synth import (featurize, make_synthetic_bank,
                                        sample_mixtures)
from dl4ss_tpu_torch.models.separator import Separator
from dl4ss_tpu_torch.serve import (recursive_waveforms, select_and_separate,
                                   separate_waveforms)
from dl4ss_tpu_torch.train.state import create_train_state
from dl4ss_tpu_torch.train.steps import (make_adversarial_step,
                                         make_classifier_step,
                                         make_dense_train_step,
                                         make_fused_step)
from dl4ss_tpu_torch.utils import span

PHASES = {"sample", "featurize", "forward", "backward", "optimizer",
          "features", "separate", "resynthesis"}
TDAA = dict(encoder_rnn="lstm", is_self_tune=True, use_discriminator=True)
KERNELS = dict(use_pallas_rnn=True, use_pallas_stft=True,
               use_pallas_maskhead=True)


def _spans(fn) -> collections.Counter:
    """The `dl4ss.` host events that one call of `fn` opens, by phase."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return collections.Counter(e.name[len("dl4ss."):] for e in prof.events()
                               if e.name.startswith("dl4ss."))


def _bank(cfg) -> torch.Tensor:
    return torch.as_tensor(make_synthetic_bank(0, cfg.num_speakers, 2,
                                               cfg.max_len))


def test_span_off_is_one_shared_no_op():
    a, b = span("forward"), span("sample")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass


def test_span_reads_the_gate_at_each_call():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = span("forward")
        with on:
            torch.ones(2).sum()
    assert not isinstance(on, contextlib.nullcontext)
    assert isinstance(span("forward"), contextlib.nullcontext)
    assert [e.name for e in prof.events()
            if e.name.startswith("dl4ss.")] == ["dl4ss.forward"]


def test_a_span_is_a_host_op_not_an_annotation():
    """The profiler copies a user annotation (`record_function`) onto the
    card's timeline, where it would read as device work; a span stays a
    host op."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("sample"):
            torch.ones(2).sum()
    (event,) = [e for e in prof.events() if e.name == "dl4ss.sample"]
    assert event.device_type == torch.autograd.DeviceType.CPU
    assert not event.is_user_annotation


@pytest.mark.parametrize("flags", [{}, KERNELS], ids=["plain", "kernels"])
def test_joint_step_opens_each_phase_once(flags):
    cfg = preset("synth_tiny").replace(**flags)
    state = create_train_state(cfg, seed=0, device="cpu")
    bank = _bank(cfg)
    step = make_fused_step(cfg)
    step(state, bank)
    assert _spans(lambda: step(state, bank)) == {
        "sample": 1, "featurize": 1, "forward": 1, "backward": 1,
        "optimizer": 1}


@pytest.mark.parametrize("make, overrides, per_step", [
    (make_adversarial_step, TDAA, 2),
    (make_dense_train_step, dict(TDAA, use_discriminator=False), 1),
    (make_classifier_step, {}, 1),
], ids=["adversarial", "dense", "classifier"])
def test_trainer_opens_forward_backward_optimizer(make, overrides, per_step):
    """A step on given features: the adversarial step's two phases each
    run forward, backward and optimizer; the other trainers once."""
    cfg = preset("synth_tiny").replace(**overrides)
    state = create_train_state(cfg, seed=0, device="cpu")
    feats = featurize(sample_mixtures(torch.Generator().manual_seed(0),
                                      _bank(cfg), cfg), cfg)
    step = make(cfg)
    assert _spans(lambda: step(state, feats)) == {
        "forward": per_step, "backward": per_step, "optimizer": per_step}


@pytest.mark.parametrize("program", [
    lambda m, w, c: separate_waveforms(m, w, c, spk_idx=torch.tensor(
        [[0, 1], [2, 3]])),
    select_and_separate,
    recursive_waveforms,
], ids=["given", "selected", "recursive"])
@pytest.mark.parametrize("flags", [{}, KERNELS], ids=["plain", "kernels"])
def test_serving_opens_each_phase_once(program, flags):
    cfg = preset("synth_tiny").replace(**flags)
    model = Separator(cfg, device="cpu")
    wav = torch.randn(2, cfg.max_len, generator=torch.Generator()
                      .manual_seed(0))
    assert _spans(lambda: program(model, wav, cfg)) == {
        "features": 1, "separate": 1, "resynthesis": 1}


@pytest.mark.parametrize("trunk", ["conv", "inception"])
def test_query_step_opens_forward_query_and_trunk(trunk):
    """The video-query step: its forward, the video query inside it and
    the frame trunk inside that, then backward and optimizer, each once;
    uint8 frames (normalized inside the trunk's span)."""
    from dl4ss_tpu_torch.data.video import synthetic_frame_bank
    from dl4ss_tpu_torch.train.query_trainer import (create_query_state,
                                                     make_query_train_step,
                                                     query_batch)
    cfg = preset("grid_video").replace(
        num_speakers=4, batch_size=2, max_len_seconds=0.25, hidden_units=8,
        embedding_size=4, num_layers=1, encoder_layers=1)
    hw = (75, 75)
    state = create_query_state(cfg, 0, "video", video_trunk=trunk,
                               frame_hw=hw, device="cpu")
    frames = torch.as_tensor(synthetic_frame_bank(4, 2, 2, hw,
                                                  dtype=np.uint8))
    feats = query_batch(torch.Generator().manual_seed(0), _bank(cfg), cfg,
                        "query_video", frames)
    step = make_query_train_step(cfg, "video")
    assert _spans(lambda: step(state, feats)) == {
        "forward": 1, "query": 1, "video_trunk": 1, "backward": 1,
        "optimizer": 1}


def test_only_the_eight_phases_exist():
    """Every span the separator's steps and requests open is one of the
    eight phases (the video query adds `query` and `video_trunk`)."""
    cfg = preset("synth_tiny").replace(**TDAA)
    state = create_train_state(cfg, seed=0, device="cpu")
    bank = _bank(cfg)
    step = make_adversarial_step(cfg)

    def both():
        step(state, featurize(sample_mixtures(state.generator, bank, cfg),
                              cfg))
        separate_waveforms(state.model, bank[:2, 0], cfg,
                           spk_idx=torch.tensor([[0, 1], [2, 3]]))

    assert set(_spans(both)) == PHASES
