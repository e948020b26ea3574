"""TDAA's adversarial trainer in closed loop, as `train_loop` runs it in
bank mode: each unit is `sample_mixtures` -> `featurize` ->
`make_adversarial_step` (the discriminator's phase, then the separator's
against it)."""

from __future__ import annotations

from benchmark.harness import flopcount as fc
from benchmark.harness.training import TrainDriver
from benchmark.reference import train as ref_train


def count(layers, c: dict, b: int) -> fc.Count:
    """A step of `b` mixtures: the STFT of the mixtures and their K
    sources; phase 1, the separator's no-grad forward and the
    discriminator on the real and the predicted spectra of every source
    with its backward (twice its forward); phase 2, the separator's
    forward and backward, and the discriminator on the prediction with
    the gradient to its input (once more its forward)."""
    sep, disc = layers.separator(c, b), layers.discriminator(c)
    images = b * c["max_mix"]
    ops = (fc.stft(c, b * (1 + c["max_mix"])) + sep.model
           + 3 * 2 * images * disc + 3 * sep.model + 2 * images * disc)
    return fc.Count(ops, sep.recurrence + sep.recurrence
                    + fc.backward(sep.recurrence))


class Driver(TrainDriver):
    loss_keys = ("d_loss", "g_loss")
    late_keys = ("d_loss",)   # g_loss follows the step's own update

    def make_step(self, cfg, steps_per_epoch):
        from dl4ss_tpu_torch.train.steps import make_adversarial_step
        return make_adversarial_step(cfg, steps_per_epoch)

    def step_once(self):
        from dl4ss_tpu_torch.data.synth import featurize, sample_mixtures
        batch = sample_mixtures(self.state.generator, self.bank, self.cfg)
        self.state, metrics = self.step(self.state,
                                        featurize(batch, self.cfg))
        return metrics

    def ref_optimizers(self, params, c):
        dis = [n for n in params if n.startswith("discriminator.")]
        return [ref_train.Adam(params, ref_train.generator_names(params), c),
                ref_train.Adam(params, dis, c)]

    def ref_step(self, params, opts, batch, c):
        return ref_train.adversarial_step(params, opts[0], opts[1], batch, c)

    def ref_late(self, params, batch, c):
        return ref_train.adversarial_late(params, batch, c)
