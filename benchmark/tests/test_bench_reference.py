"""The plain reference against the port's CPU path, for each
configuration at a small size, on the same weights and inputs.

Tolerances, fixed beforehand: float32 sums in another order differ by
~1e-6 relative; the bf16 mask head can round one operand the other way
when its float32 input differs in the last bits, which moves that mask by
up to ~2^-8 of its logit, so masks and what follows them are held to
looser bounds than the encoder."""

from __future__ import annotations

import pytest
import torch

from conftest import TINY

from benchmark.harness.program import Ctx, build_model, port_config
from benchmark.harness import registry
from benchmark.harness.checks import rel_err
from benchmark.reference import model as rm
from benchmark.reference import train as rt
from benchmark.reference.dsp import istft, stft
from benchmark.reference.params import make_params
from benchmark.traffic.bank import make_bank
from benchmark.traffic.mixing import replay_batch, request_pool

CONFIGS = ("torch_multi", "tdaa")


def _setup(name):
    config = registry.load_json("configs", name)
    for key, patch in TINY.items():
        config[key] = dict(config[key], **patch)
    ctx = Ctx(name, 7, 1.0, torch.device("cpu"), config, {}, {})
    cfg = port_config(config)
    model = build_model(ctx, cfg)
    params = make_params(ctx.ref, ctx.sub_seed("weights"), "cpu")
    bank = make_bank(5, cfg.num_speakers, 3, cfg.max_len, cfg.frame_rate,
                     "cpu")
    return ctx, cfg, model, params, bank


def test_dsp_matches_the_port():
    from dl4ss_tpu_torch.ops.stft import istft as port_istft
    from dl4ss_tpu_torch.ops.stft import stft as port_stft
    x = torch.randn(3, 4000, generator=torch.Generator().manual_seed(0))
    spec = stft(x, 256, 128)
    assert rel_err(spec.abs(), port_stft(x).abs()) < 1e-5
    assert rel_err(istft(spec, 256, 128), port_istft(spec)) < 1e-5
    assert rel_err(istft(spec, 256, 128), x[:, :istft(spec, 256, 128)
                                             .shape[-1]]) < 1e-5


@pytest.mark.parametrize("name", CONFIGS)
def test_serving_matches_the_port(name):
    from dl4ss_tpu_torch.models.classifier import apply_classifier
    from dl4ss_tpu_torch.models.encoder import encoder_hidden
    from dl4ss_tpu_torch.serve import separate_waveforms
    ctx, cfg, model, params, bank = _setup(name)
    c = ctx.ref
    reqs = request_pool(3, bank, 4, 2, 5.0)
    spec = stft(reqs.mix, c["frame_length"], c["frame_shift"])
    mag = spec.abs()
    with torch.no_grad():
        assert rel_err(rm.encoder_hidden(params, mag, c),
                       encoder_hidden(model.encoder, mag, cfg)) < 1e-5
        assert rel_err(rm.classifier_probs(params, mag, c),
                       apply_classifier(model.classifier, mag, cfg)) < 1e-5
        want = rm.resynthesise(rm.separate(params, mag, reqs.spk_idx,
                                           c).masks, spec, c)
    got = separate_waveforms(model, reqs.mix, cfg, spk_idx=reqs.spk_idx)
    assert rel_err(got, want) < 1e-3


@pytest.mark.parametrize("name", CONFIGS)
def test_first_training_step_matches_the_port(name):
    from dl4ss_tpu_torch.data.synth import featurize, sample_mixtures
    from dl4ss_tpu_torch.train.state import create_train_state
    from dl4ss_tpu_torch.train.steps import (make_adversarial_step,
                                             make_train_step)
    ctx, cfg, model, params, bank = _setup(name)
    c = ctx.ref
    state = create_train_state(cfg, 0, cfg.epoch_size, "cpu", model=model)
    batch = sample_mixtures(torch.Generator().manual_seed(11), bank, cfg)
    ref_batch = replay_batch(torch.Generator().manual_seed(11), bank, c)
    assert torch.equal(batch.mix_wav, ref_batch.mix)
    g_opt = rt.Adam(params, rt.generator_names(params), c)
    if cfg.use_discriminator:
        step = make_adversarial_step(cfg, cfg.epoch_size)
        d_opt = rt.Adam(params, [n for n in params
                                 if n.startswith("discriminator.")], c)
        _, m = step(state, featurize(batch, cfg))
        (d_loss, g_loss), _ = rt.adversarial_step(params, g_opt, d_opt,
                                                  ref_batch, c)
        pairs = [(float(m["d_loss"]), d_loss), (float(m["g_loss"]), g_loss)]
    else:
        _, m = make_train_step(cfg)(state, featurize(batch, cfg))
        loss, _ = rt.joint_step(params, g_opt, ref_batch, c)
        pairs = [(float(m["loss"]), loss)]
    for got, want in pairs:
        assert abs(got - want) <= 1e-5 * abs(want)
    # Adam's first update is about lr * sign(g): an element whose gradient
    # lies within rounding of 0 can take the other sign, so the updates
    # are held by their share of elements that agree
    p0 = make_params(c, ctx.sub_seed("weights"), "cpu")
    for n, p in state.model.named_parameters():
        got, want = p.detach() - p0[n], params[n] - p0[n]
        agree = (torch.sign(got) == torch.sign(want)).float().mean()
        assert float(agree) > 0.97, n
