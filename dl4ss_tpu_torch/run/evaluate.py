"""Evaluation CLI — the port of `dl4ss_tpu/run/evaluate.py`, the modes the
port runs: held-out synthetic mixtures scored by SI-SDR on the device.

    python -m dl4ss_tpu_torch.run.evaluate --checkpoint-dir ck --batches 10
    python -m dl4ss_tpu_torch.run.evaluate --checkpoint-dir ck \
        --teacher-forced
    python -m dl4ss_tpu_torch.run.evaluate --checkpoint-dir ck \
        --mode recursive [--candidates 6]

`--mode separate` scores the top-k separator with teacher-forced speakers
(`--teacher-forced`) or the classifier's top-k, optionally with the
1-speaker complement mask, a per-sample candidate roster (`--candidates
N`, with the speaker hit rate) or embedding-cosine dedup (`--dedup`);
`--mode recursive` scores the peel loop per step, with the speaker hit
rate. The model is `--checkpoint-dir`'s latest step under its cfg.json,
with `--graft component=dir,...` over it (random weights from --seed
without either). `--mix-k` sets how many speakers each mixture holds,
within what the synthetic sampler draws. Not ported yet, each exiting with
a one-line message: BSS-Eval, the oracle bound and the wav export (ROADMAP
P11); the wsj0-mix lists, Cocktail wavlists and noise wavs (P10); the
memory mode and its options (P12).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dl4ss_tpu_torch.data.synth import featurize, sample_mixtures
from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.models.separator import classify_speakers
from dl4ss_tpu_torch.objectives.select import (candidate_pools,
                                               candidate_restricted_select,
                                               cosine_dedup_select)
from dl4ss_tpu_torch.run.common import (add_common_args, build_cfg,
                                        checkpoint_cfg, load_bank,
                                        restore_for_eval)
from dl4ss_tpu_torch.train.steps import (make_eval_step,
                                         make_recursive_eval_step)

# options of later ROADMAP items: each refuses with its item's name
_LATER = {"bss_eval": "P11", "oracle": "P11", "export_wavs": "P11",
          "list_dir": "P10", "wav_root": "P10", "file_lists": "P10",
          "noise_wavs": "P10", "query_source": "P12", "video_trunk": "P12",
          "frame_size": "P12", "enroll_seconds": "P12", "unk_holdout": "P12",
          "unk_root": "P12"}


def _hits(spk_idx: torch.Tensor, live: torch.Tensor, chosen: torch.Tensor):
    """(true speakers recovered in `chosen`, true speakers) over a batch."""
    hits = total = 0
    for true, alive, pick in zip(spk_idx.tolist(), live.tolist(),
                                 chosen.tolist()):
        tset = {s for s, a in zip(true, alive) if a}
        hits += len(tset & set(pick))
        total += len(tset)
    return hits, total


def main(argv=None):
    p = add_common_args(argparse.ArgumentParser(description=__doc__))
    p.add_argument("--batches", type=int, default=4,
                   help="held-out batches to score")
    p.add_argument("--mode", default="separate",
                   choices=["separate", "recursive", "memory"],
                   help="recursive = peel-and-subtract extraction scored "
                        "per step (main_run_multi_selfSS_recu.py:341-409); "
                        "memory is not ported yet (ROADMAP P12)")
    p.add_argument("--teacher-forced", action="store_true",
                   help="use the ground-truth speakers; default: the "
                        "classifier's top-k")
    p.add_argument("--complement-mask", action="store_true",
                   help="1-speaker complement trick: channel 2's mask "
                        "becomes 1 - mask_1 when the classifier sees one "
                        "speaker (TestVer:473-476)")
    p.add_argument("--candidates", type=int, default=None, metavar="N",
                   help="restrict classifier selection to a per-sample "
                        "roster of N speakers (the true ones + random "
                        "distractors, predata_multiSpeechTest.py:89-115)")
    p.add_argument("--dedup", action="store_true",
                   help="speaker selection by embedding-cosine dedup "
                        "(main_run_multi_selfSS_quchong.py:398-445)")
    p.add_argument("--mix-k", default=None,
                   help="speakers per mixture, comma-separated for mixed "
                        "counts (e.g. 1,2); default: the config's "
                        "min_mix..max_mix")
    p.add_argument("--graft", default=None,
                   help="checkpoint-zoo composition: comma-separated "
                        "component=ckpt_dir pairs grafted over "
                        "--checkpoint-dir (e.g. classifier=ck_cls)")
    p.add_argument("--bss-eval", action="store_true",
                   help="not ported yet (ROADMAP P11)")
    for flag, item in (("--oracle", "P11"), ("--export-wavs", "P11"),
                       ("--list-dir", "P10"), ("--wav-root", "P10"),
                       ("--file-lists", "P10"), ("--noise-wavs", "P10"),
                       ("--query-source", "P12"), ("--video-trunk", "P12"),
                       ("--frame-size", "P12"), ("--enroll-seconds", "P12"),
                       ("--unk-holdout", "P12"), ("--unk-root", "P12")):
        p.add_argument(flag, default=None,
                       help=f"not ported yet (ROADMAP {item})")
    args = p.parse_args(argv)

    if args.mode == "memory":
        raise SystemExit("--mode memory (the life-long speaker memory) is "
                         "not ported yet (ROADMAP P12)")
    for name, item in _LATER.items():
        if getattr(args, name) not in (None, False):
            raise SystemExit(f"--{name.replace('_', '-')} is not ported yet "
                             f"(ROADMAP {item})")
    if args.mode == "recursive" and (args.dedup or args.teacher_forced
                                     or args.complement_mask):
        raise SystemExit(
            "--mode recursive selects one speaker per peel step itself; "
            "--dedup/--teacher-forced/--complement-mask apply to the "
            "simultaneous top-k evaluator only (--candidates composes: it "
            "restricts each peel step to the roster)")
    if args.candidates and (args.dedup or args.teacher_forced):
        raise SystemExit("--candidates is its own selection protocol; drop "
                         "--dedup/--teacher-forced")

    # the training config governs the state, the protocol and the audio
    # geometry, so it is adopted before the eval data is built
    cfg = checkpoint_cfg(build_cfg(args), args)
    if args.candidates and args.candidates < cfg.top_k:
        raise SystemExit(f"--candidates must be >= top_k={cfg.top_k}")
    if args.mix_k:
        ks = sorted(int(k) for k in args.mix_k.split(","))
        if ks[0] < 1 or (args.mode == "separate" and ks[-1] != cfg.top_k):
            raise SystemExit(
                f"--mix-k {args.mix_k}: the synthetic sampler draws "
                f"max_mix channels and the top-k evaluator scores top_k="
                f"{cfg.top_k} of them, so the largest count must be "
                f"{cfg.top_k} (fewer live speakers per mixture down to the "
                f"smallest); --mode recursive takes any counts >= 1")
        cfg = cfg.replace(min_mix=ks[0], max_mix=ks[-1]).validate()
    device = resolve_device(args.device)
    bank = load_bank(cfg, args, device)
    state = restore_for_eval(cfg, args, device)
    model = state.model
    ev = (make_recursive_eval_step(cfg) if args.mode == "recursive"
          else make_eval_step(cfg))

    all_sisdr = []
    hits = hit_total = 0
    generator = torch.Generator().manual_seed(args.seed + 1)
    for _ in range(args.batches):
        batch = sample_mixtures(generator, bank, cfg, train=False)
        feats = featurize(batch, cfg)
        pools = None
        if args.candidates:
            pools = candidate_pools(generator, feats["spk_idx"],
                                    feats["channel_live"], args.candidates,
                                    cfg.num_speakers)
        if args.mode == "recursive":
            if pools is not None:
                feats["candidates"] = pools
            out = ev(model, feats)
            chosen = out["spk_steps"]
        elif args.dedup or pools is not None:
            with torch.no_grad():
                probs = classify_speakers(model, feats["mix_feas"], cfg)
            if args.dedup:
                sel = cosine_dedup_select(probs, model.embedding.table,
                                          cfg.quchong_alpha, cfg.top_k)
            else:
                sel = candidate_restricted_select(probs, pools, cfg.top_k)
            chosen = sel
            out = ev(model, dict(feats, spk_idx=sel), teacher_forced=True,
                     complement_mask=args.complement_mask)
        else:
            chosen = None
            out = ev(model, feats, teacher_forced=args.teacher_forced,
                     complement_mask=args.complement_mask)
        if chosen is not None and (args.mode == "recursive"
                                   or pools is not None):
            h, n = _hits(batch.spk_idx, batch.gains > 0, chosen)
            hits, hit_total = hits + h, hit_total + n
        all_sisdr.append(out["si_sdr"].float().cpu().numpy())

    sisdr = float(np.mean(np.concatenate(all_sisdr)))
    print(f"SI-SDR over {args.batches} batches: {sisdr:.2f} dB")
    if hit_total:
        print(f"speaker hit rate: {hits}/{hit_total} "
              f"({100.0 * hits / hit_total:.1f}%)")
    return sisdr


if __name__ == "__main__":
    main()
