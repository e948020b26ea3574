"""CLI entry points of the port.

  python -m dl4ss_tpu_torch.run.separate  — separate mixture wav(s) into
                                            given speakers (top-k)
  python -m dl4ss_tpu_torch.run.train     — train the separator (joint mode)
"""
