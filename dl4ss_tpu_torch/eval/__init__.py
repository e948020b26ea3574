"""Evaluation metrics: SI-SDR and its permutation-resolved form, BSS-Eval,
the oracle-mask bounds, classifier metrics and the wav export."""
