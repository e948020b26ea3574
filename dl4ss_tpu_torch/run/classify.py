"""Classifier CLI — the port of `dl4ss_tpu/run/classify.py`, synthetic-bank
mode.

Trains the multi-label "who is in the mixture" classifier alone and reports
the reference's metric suite on held-out batches: element/sample accuracy,
top-k recall (the '80% top-3 recall' number), hamming loss, micro/macro
P/R/F1.

    python -m dl4ss_tpu_torch.run.classify --preset torch_multi --epochs 5 \
        --checkpoint-dir ck_cls
    python -m dl4ss_tpu_torch.run.classify --eval-only --checkpoint-dir ck_cls
    python -m dl4ss_tpu_torch.run.classify --preset synth_tiny --device cpu \
        --epochs 1 --epoch-size 2 --eval-batches 1

`--checkpoint-dir` saves the trained state there; with `--eval-only` the
CLI restores its latest step (under its cfg.json) instead of training and
reports the metric suite. Not ported yet, exiting with a one-line message:
`--list-dir` (the wsj0-mix lists, ROADMAP P10).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dl4ss_tpu_torch.data.synth import featurize, sample_mixtures
from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.eval.classifier_metrics import (multilabel_accuracy,
                                                     multilabel_prf,
                                                     topk_recall)
from dl4ss_tpu_torch.models.separator import classify_speakers
from dl4ss_tpu_torch.run.common import (add_common_args, build_cfg,
                                        checkpoint_cfg, load_bank,
                                        restore_for_eval)
from dl4ss_tpu_torch.train.loop import train_loop


def main(argv=None):
    p = add_common_args(argparse.ArgumentParser(description=__doc__))
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--epoch-size", type=int, default=None)
    p.add_argument("--eval-batches", type=int, default=4)
    p.add_argument("--topk", type=int, default=3)
    p.add_argument("--list-dir", default=None,
                   help="official wsj0-mix list directory (not ported yet, "
                        "ROADMAP P10)")
    p.add_argument("--eval-only", action="store_true",
                   help="restore --checkpoint-dir and report the metric "
                        "suite without training")
    args = p.parse_args(argv)
    if args.list_dir:
        raise SystemExit("--list-dir (the wsj0-mix lists) is not ported yet "
                         "(ROADMAP P10); omit it for the synthetic bank")
    if args.eval_only and not args.checkpoint_dir:
        raise SystemExit("--eval-only restores --checkpoint-dir; pass one")

    cfg = build_cfg(args)
    if args.eval_only:
        # the state shapes come from the training config; the CLI's
        # overrides win on top
        cfg = checkpoint_cfg(cfg, args)
    device = resolve_device(args.device)
    bank = load_bank(cfg, args, device)
    if args.eval_only:
        state = restore_for_eval(cfg, args, device)
    else:
        state, _ = train_loop(cfg, bank=bank, max_epochs=args.epochs,
                              epoch_size=args.epoch_size, seed=args.seed,
                              mode="classifier", metrics_path=args.metrics,
                              checkpoint_dir=args.checkpoint_dir,
                              eval_every=0, device=device)

    # held-out metrics (the test_multi_labels_speech_metrics.py report)
    probs_all, targets_all = [], []
    generator = torch.Generator().manual_seed(args.seed + 7)
    for _ in range(args.eval_batches):
        batch = sample_mixtures(generator, bank, cfg, train=False)
        feats = featurize(batch, cfg)
        with torch.no_grad():
            probs = classify_speakers(state.model, feats["mix_feas"], cfg)
        probs = probs.float().cpu().numpy()
        target = np.zeros_like(probs)
        idx = batch.spk_idx.cpu().numpy()
        live = (batch.gains > 0).cpu().numpy()
        for b in range(idx.shape[0]):
            target[b, idx[b][live[b]]] = 1.0
        probs_all.append(probs)
        targets_all.append(target)
    probs = np.concatenate(probs_all)
    targets = np.concatenate(targets_all)
    report = {**multilabel_accuracy(probs, targets, cfg.alpha),
              **multilabel_prf(probs, targets, cfg.alpha),
              f"top{args.topk}_recall": topk_recall(probs, targets, args.topk)}
    for k, v in report.items():
        print(f"{k}: {v:.4f}")
    return report


if __name__ == "__main__":
    main()
