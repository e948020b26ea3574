"""Utilities: profiling, determinism, timing."""

from dl4ss_tpu_torch.utils.profiling import profile_trace, span, StepTimer  # noqa: F401
from dl4ss_tpu_torch.utils.determinism import seed_everything  # noqa: F401
