"""The trainer: train state and optimizers, the train / fused / eval steps,
the metrics writer, checkpoints and the epoch loop. The names below are
those `dl4ss_tpu.train` exports."""

from dl4ss_tpu_torch.train.state import (  # noqa: F401
    TrainState, create_train_state, make_schedule)
from dl4ss_tpu_torch.train.steps import (  # noqa: F401
    make_train_step, make_dense_train_step, make_classifier_step,
    make_adversarial_step, make_eval_step)
from dl4ss_tpu_torch.train.metrics import MetricsWriter  # noqa: F401
from dl4ss_tpu_torch.train.checkpoint import (  # noqa: F401
    save_checkpoint, restore_checkpoint, latest_step)
from dl4ss_tpu_torch.train.loop import train_loop  # noqa: F401
