"""Classifier CLI — the port of `dl4ss_tpu/run/classify.py`.

Trains the multi-label "who is in the mixture" classifier alone and reports
the reference's metric suite on held-out batches: element/sample accuracy,
top-k recall (the '80% top-3 recall' number), hamming loss, micro/macro
P/R/F1.

    python -m dl4ss_tpu_torch.run.classify --preset torch_multi --epochs 5 \
        --checkpoint-dir ck_cls
    python -m dl4ss_tpu_torch.run.classify --eval-only --checkpoint-dir ck_cls
    python -m dl4ss_tpu_torch.run.classify --preset synth_tiny --device cpu \
        --epochs 1 --epoch-size 2 --eval-batches 1

    python -m dl4ss_tpu_torch.run.classify --preset torch_multi \
        --list-dir corpus/lists --wav-root corpus --checkpoint-dir ck_cls

Trains on the synthetic bank, a speaker tree (--data-root) or the wsj0-mix
lists (--list-dir: the tr lists of --split, scored on the --eval-split
lists under the TRAIN vocabulary, the list-fed classifier fork
TDAA_beta/test_multi_labels_speech.py). `--checkpoint-dir` saves the
trained state there; with `--eval-only` the CLI restores its latest step
(under its cfg.json, and its vocab.json in list mode) instead of training
and reports the metric suite.
"""

from __future__ import annotations

import argparse
import os

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
                                        read_vocab, restore_for_eval)
from dl4ss_tpu_torch.train.checkpoint import load_cfg
from dl4ss_tpu_torch.train.loop import train_loop


def main(argv=None):
    p = add_common_args(argparse.ArgumentParser(description=__doc__))
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--epoch-size", type=int, default=None)
    p.add_argument("--eval-batches", type=int, default=4)
    p.add_argument("--topk", type=int, default=3)
    p.add_argument("--list-dir", default=None,
                   help="official wsj0-mix list directory: train from the "
                        "tr lists and report the metric suite over the cv "
                        "(or tt) lists under the TRAIN vocabulary")
    p.add_argument("--wav-root", default=None,
                   help="root the list wav paths are relative to")
    p.add_argument("--eval-split", default="valid",
                   help="list mode: the split the metric report scores "
                        "(valid | test | train)")
    p.add_argument("--mix-k", default="2",
                   help="mixture speaker count(s) of the lists, "
                        "comma-separated")
    p.add_argument("--eval-only", action="store_true",
                   help="restore --checkpoint-dir and report the metric "
                        "suite without training")
    args = p.parse_args(argv)
    if args.eval_only and not args.checkpoint_dir:
        raise SystemExit("--eval-only restores --checkpoint-dir; pass one")

    cfg = build_cfg(args)
    ck_cfg = None
    if args.eval_only:
        # the state shapes come from the training config; the CLI's
        # overrides win on top
        ck_cfg = load_cfg(args.checkpoint_dir)
        cfg = checkpoint_cfg(cfg, args)
    device = resolve_device(args.device)
    bank = sampler = eval_iter = None
    if args.list_dir:
        from dl4ss_tpu_torch.data.listsampler import Wsj0MixSampler
        from dl4ss_tpu_torch.data.wsj0mix import mix_list_name
        root = args.wav_root or "."
        mix_ks = tuple(int(x) for x in str(args.mix_k).split(","))
        # the metric split is read under the TRAIN vocabulary (speaker ->
        # label column is an artifact of the tr lists); --eval-only takes
        # it from the vocab.json that run.train records, without decoding
        # the training bank
        spk2idx = read_vocab(args.checkpoint_dir) if args.eval_only else None
        if spk2idx is not None:
            if ck_cfg is not None and len(spk2idx) != ck_cfg.num_speakers:
                raise SystemExit(
                    f"vocab.json lists {len(spk2idx)} speakers but the "
                    f"checkpoint config was trained with "
                    f"{ck_cfg.num_speakers}; the checkpoint sidecars are "
                    f"inconsistent")
            if ck_cfg is None:
                cfg = cfg.replace(num_speakers=len(spk2idx))
        else:
            sampler = Wsj0MixSampler(args.list_dir, root, cfg, args.split,
                                     mix_ks=mix_ks, device=device)
            cfg = cfg.replace(num_speakers=sampler.num_speakers)
            spk2idx = sampler.spk2idx
        ev_split = args.eval_split
        if not any(os.path.exists(os.path.join(args.list_dir,
                                               mix_list_name(k, ev_split)))
                   for k in mix_ks):
            ev_split = args.split
        ev_sampler = Wsj0MixSampler(args.list_dir, root, cfg, ev_split,
                                    mix_ks=mix_ks, spk2idx=spk2idx,
                                    device=device)
        n_ev = min(args.eval_batches,
                   ev_sampler.num_batches(cfg.batch_size_eval))
        if n_ev == 0:
            raise SystemExit(
                f"the {ev_split} lists form no full batch at "
                f"batch_size_eval={cfg.batch_size_eval}")
        eval_iter = ev_sampler.batches(cfg.batch_size_eval, shuffle=False)
        args.eval_batches = n_ev
    else:
        bank, cfg, _ = load_bank(cfg, args, device)
    if args.eval_only:
        state = restore_for_eval(cfg, args, device)
    else:
        state, _ = train_loop(cfg, bank=bank, max_epochs=args.epochs,
                              epoch_size=args.epoch_size, seed=args.seed,
                              mode="classifier", metrics_path=args.metrics,
                              checkpoint_dir=args.checkpoint_dir,
                              eval_every=0, sampler=sampler, device=device)

    # held-out metrics (the test_multi_labels_speech_metrics.py report)
    probs_all, targets_all = [], []
    generator = torch.Generator().manual_seed(args.seed + 7)
    for _ in range(args.eval_batches):
        if eval_iter is not None:
            batch = next(eval_iter)
        else:
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
