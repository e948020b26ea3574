"""The trainer: train state and optimizers, the train / fused / eval steps,
the metrics writer and the epoch loop."""
