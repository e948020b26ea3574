"""Separated-wav export following the reference's batch_output contract.

File naming (Torch_multi/main_run.py:29-60, bss_test.py:12-61):
  {idx}_{spk}_pre.wav       predicted separation for speaker `spk`
  {idx}_{spk}_genTrue.wav   masked-ground-truth resynthesis
  {idx}_{spk}_realTrue.wav  raw clean source (subeval variant, :66-72)
  {idx}_True_mix.wav        the mixture

so results remain eyeball- and tool-compatible with the reference's output
directories. (The port's copy of `dl4ss_tpu/eval/wav_export.py`; it takes
numpy arrays.)
"""

from __future__ import annotations

import os
import shutil
from typing import Optional, Sequence

import numpy as np

from dl4ss_tpu_torch.data.wavio import write_wav


def export_batch_outputs(out_dir, mix_wavs: np.ndarray,
                         pred_wavs: np.ndarray,
                         true_wavs: Optional[np.ndarray],
                         spk_names: Sequence[Sequence[str]],
                         rate: int = 8000, clean: bool = True,
                         real_wavs: Optional[np.ndarray] = None,
                         idx_offset: int = 0,
                         live: Optional[np.ndarray] = None,
                         pred_names: Optional[Sequence[Sequence[str]]]
                         = None) -> int:
    """mix (B, N), pred (B, Kp, N), true/real (B, K, N), spk_names[b][k].
    Returns #files. `idx_offset` shifts the mixture index so successive
    batches land in one directory without colliding (pass clean=False for
    batches after the first). pred may carry more channels than true/real
    (recursive peel steps; extra pred channels are named by step) OR fewer
    (top_k < sampler k: every live reference is still written so run.score
    sees the complete true source set). `live` (B, K) skips the true/real
    wavs of dead (zero-gain) channels so run.score never scores against a
    silent reference. `pred_names` overrides spk_names for the PRE wavs
    only — recursive peel steps extract speakers in loop order, not the
    reference channel order, and the naming contract says the file carries
    THAT speaker's estimate."""
    if pred_names is None:
        pred_names = spk_names
    if clean and os.path.exists(out_dir):
        shutil.rmtree(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    b, kp, _ = np.asarray(pred_wavs).shape
    k_ref = max((np.asarray(w).shape[1] for w in (true_wavs, real_wavs)
                 if w is not None), default=0)
    for bi in range(b):
        idx = bi + idx_offset
        for ki in range(max(kp, k_ref)):
            spk = (spk_names[bi][ki] if ki < len(spk_names[bi])
                   else f"step{ki}")
            if ki < kp:
                pspk = (pred_names[bi][ki] if ki < len(pred_names[bi])
                        else f"step{ki}")
                write_wav(os.path.join(out_dir, f"{idx}_{pspk}_pre.wav"),
                          np.asarray(pred_wavs[bi, ki]), rate)
                count += 1
            ref_live = live is None or (ki < live.shape[1] and live[bi, ki])
            if not ref_live:
                continue
            if true_wavs is not None and ki < np.asarray(true_wavs).shape[1]:
                write_wav(os.path.join(out_dir, f"{idx}_{spk}_genTrue.wav"),
                          np.asarray(true_wavs[bi, ki]), rate)
                count += 1
            if real_wavs is not None and ki < np.asarray(real_wavs).shape[1]:
                write_wav(os.path.join(out_dir, f"{idx}_{spk}_realTrue.wav"),
                          np.asarray(real_wavs[bi, ki]), rate)
                count += 1
        write_wav(os.path.join(out_dir, f"{idx}_True_mix.wav"),
                  np.asarray(mix_wavs[bi]), rate)
        count += 1
    return count
