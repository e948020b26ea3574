"""The joint trainer in closed loop: each unit is one step of
`train.steps.make_fused_step` on the device-resident bank (the program's
own sampling, K1 featurisation, separator, PIT MSE, backward and clipped
Adam), as `train_loop` runs the joint mode."""

from __future__ import annotations

from benchmark.harness import flopcount as fc
from benchmark.harness.training import TrainDriver
from benchmark.reference import train as ref_train


def count(layers, c: dict, b: int) -> fc.Count:
    """A step of `b` mixtures: the STFT of the mixtures and their K
    sources, and the separator's forward and backward (twice its
    forward)."""
    sep = layers.separator(c, b)
    return fc.Count(fc.stft(c, b * (1 + c["max_mix"])) + 3 * sep.model,
                    sep.recurrence + fc.backward(sep.recurrence))


class Driver(TrainDriver):
    loss_keys = ("loss",)
    late_keys = ("loss",)

    def make_step(self, cfg, steps_per_epoch):
        from dl4ss_tpu_torch.train.steps import make_fused_step
        return make_fused_step(cfg, steps_per_epoch)

    def step_once(self):
        self.state, metrics = self.step(self.state, self.bank)
        return metrics

    def ref_optimizers(self, params, c):
        return [ref_train.Adam(params, ref_train.generator_names(params), c)]

    def ref_step(self, params, opts, batch, c):
        loss, grads = ref_train.joint_step(params, opts[0], batch, c)
        return (loss,), grads

    def ref_late(self, params, batch, c):
        return ref_train.joint_late(params, batch, c)
