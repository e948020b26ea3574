"""Evaluation metrics: SI-SDR and its permutation-resolved form, BSS-Eval,
the oracle-mask bounds, classifier metrics and the wav export. The names
below are those `dl4ss_tpu.eval` exports."""

from dl4ss_tpu_torch.eval.sisdr import si_sdr, si_sdr_pit, sdr_simple  # noqa: F401
from dl4ss_tpu_torch.eval.bss_eval import (  # noqa: F401
    bss_eval_sources, bss_eval_sources_numpy, nsdr)
from dl4ss_tpu_torch.eval.classifier_metrics import (  # noqa: F401
    multilabel_accuracy, topk_recall, multilabel_prf)
from dl4ss_tpu_torch.eval.wav_export import export_batch_outputs  # noqa: F401
