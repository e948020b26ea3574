"""CLI entry points of the port.

  python -m dl4ss_tpu_torch.run.separate  — separate mixture wav(s) into
                                            given or classifier-picked
                                            speakers (top-k or recursive)
  python -m dl4ss_tpu_torch.run.train     — train the separator (joint,
                                            dense, adversarial) or the
                                            classifier
  python -m dl4ss_tpu_torch.run.classify  — train / evaluate the classifier
  python -m dl4ss_tpu_torch.run.evaluate  — score a checkpoint by SI-SDR
                                            and BSS-Eval, export wavs
  python -m dl4ss_tpu_torch.run.score     — BSS-Eval SDR of an exported
                                            wav directory (bss_test.cal)
  python -m dl4ss_tpu_torch.run.analyze   — PCA of the speaker embeddings
"""

from dl4ss_tpu_torch.run.common import (  # noqa: F401
    add_common_args, build_cfg, load_bank)
