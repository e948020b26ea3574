"""Evaluation metrics: SI-SDR and its permutation-resolved form."""
