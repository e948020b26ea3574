"""Evaluation CLI — the port of `dl4ss_tpu/run/evaluate.py`: held-out
mixtures scored by SI-SDR on the device and, on request, by BSS-Eval
SDR / SIR / SAR (the reference's bss_test.cal protocol), with the oracle
bound and the wavs exported under the batch_output naming contract.

    python -m dl4ss_tpu_torch.run.evaluate --checkpoint-dir ck --batches 10
    python -m dl4ss_tpu_torch.run.evaluate --checkpoint-dir ck \
        --teacher-forced
    python -m dl4ss_tpu_torch.run.evaluate --checkpoint-dir ck \
        --mode recursive [--candidates 6]
    python -m dl4ss_tpu_torch.run.evaluate --checkpoint-dir ck \
        --list-dir corpus/lists --wav-root corpus --split test \
        --teacher-forced --bss-eval --oracle irm --export-wavs out
    python -m dl4ss_tpu_torch.run.score out --nsdr

`--mode separate` scores the top-k separator with teacher-forced speakers
(`--teacher-forced`) or the classifier's top-k, optionally with the
1-speaker complement mask, a per-sample candidate roster (`--candidates
N`, with the speaker hit rate) or embedding-cosine dedup (`--dedup`);
`--mode recursive` scores the peel loop per step, with the speaker hit
rate. The data: the synthetic bank or a speaker tree (`--data-root`,
`--batches` batches, default 4), or the whole of a split of the official
wsj0-mix lists (`--list-dir`, `--mix-k` pools, speakers indexed by the
training run's vocab.json; `--batches` caps it); `--noise-wavs` adds street
noise to every mixture. The model is `--checkpoint-dir`'s latest step under
its cfg.json, with `--graft component=dir,...` over it (random weights from
--seed without either). Not ported yet, each exiting with a one-line
message: the memory mode, its options and the Cocktail wavlists
(`--file-lists`) (ROADMAP P12).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dl4ss_tpu_torch.data.synth import (add_noise_to_mix, featurize,
                                        sample_mixtures)
from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.eval.bss_eval import bss_eval_sources
from dl4ss_tpu_torch.eval.oracle import oracle_mask_sisdr
from dl4ss_tpu_torch.eval.wav_export import export_batch_outputs
from dl4ss_tpu_torch.models.separator import classify_speakers
from dl4ss_tpu_torch.objectives.select import (candidate_pools,
                                               candidate_restricted_select,
                                               cosine_dedup_select)
from dl4ss_tpu_torch.run.common import (add_common_args, build_cfg,
                                        checkpoint_cfg, load_bank,
                                        load_noise_bank, read_vocab,
                                        restore_for_eval)
from dl4ss_tpu_torch.train.checkpoint import load_cfg
from dl4ss_tpu_torch.train.steps import (make_eval_step,
                                         make_recursive_eval_step)

# the memory mode's options (ROADMAP P12): each refuses naming the item
_P12 = ("file_lists", "query_source", "video_trunk", "frame_size",
        "enroll_seconds", "unk_holdout", "unk_root")


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
    p.add_argument("--batches", type=int, default=None,
                   help="bank modes: batches to score (default 4); list "
                        "mode: a cap on the whole split's batch count")
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
    p.add_argument("--list-dir", default=None,
                   help="official wsj0-2mix list directory "
                        "(create-speaker-mixtures): score the whole cv / tt "
                        "split (--split) instead of sampled mixtures")
    p.add_argument("--wav-root", default=None,
                   help="root the list wav paths are relative to")
    p.add_argument("--mix-k", default="2",
                   help="list mode: mixture speaker count(s), "
                        "comma-separated for mixed-k pools (e.g. 1,2,3, "
                        "predata_fromList_123.py)")
    p.add_argument("--bss-eval", action="store_true",
                   help="also run BSS-Eval (SDR / SIR / SAR, 512 taps)")
    p.add_argument("--oracle", default=None, choices=["iam", "irm"],
                   help="also report the oracle-mask SI-SDR bound of the "
                        "eval data (ideal amplitude / ratio mask)")
    p.add_argument("--export-wavs", default=None,
                   help="directory for batch_output-style wavs, scoreable "
                        "with run.score (the bss_test.cal rebuild)")
    p.add_argument("--noise-wavs", default=None,
                   help="directory of background-noise wavs added to every "
                        "eval mixture (predict.py:152-158; the noisedB "
                        "condition); the sources stay the clean references")
    p.add_argument("--graft", default=None,
                   help="checkpoint-zoo composition: comma-separated "
                        "component=ckpt_dir pairs grafted over "
                        "--checkpoint-dir (e.g. classifier=ck_cls)")
    for name in _P12:
        p.add_argument("--" + name.replace("_", "-"), default=None,
                       help="not ported yet (ROADMAP P12)")
    args = p.parse_args(argv)

    if args.mode == "memory":
        raise SystemExit("--mode memory (the life-long speaker memory) is "
                         "not ported yet (ROADMAP P12)")
    for name in _P12:
        if getattr(args, name) is not None:
            raise SystemExit(f"--{name.replace('_', '-')} is not ported yet "
                             f"(ROADMAP P12)")
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
    ck_cfg = load_cfg(args.checkpoint_dir) if args.checkpoint_dir else None
    if args.candidates and args.candidates < cfg.top_k:
        raise SystemExit(f"--candidates must be >= top_k={cfg.top_k}")
    device = resolve_device(args.device)
    list_batches = None
    if args.list_dir:
        # the reference's protocol: mean SDR over the official cv / tt lists
        # (TDAA_beta/main_run_sstune_TestVer.py:30-31,513), speakers indexed
        # by the TRAINING vocabulary that run.train records
        from dl4ss_tpu_torch.data.listsampler import Wsj0MixSampler
        mix_ks = tuple(int(x) for x in str(args.mix_k).split(","))
        sampler = Wsj0MixSampler(args.list_dir, args.wav_root or ".", cfg,
                                 args.split, mix_ks=mix_ks,
                                 spk2idx=read_vocab(args.checkpoint_dir),
                                 device=device)
        data_speakers = sampler.num_speakers
        cfg = cfg.replace(num_speakers=max(cfg.num_speakers, data_speakers))
        idx2spk = sampler.idx2spk
        list_batches = sampler.batches(cfg.batch_size_eval, shuffle=False)
        n_batches = sampler.num_batches(cfg.batch_size_eval)
        if n_batches == 0:
            raise SystemExit(
                f"every mixture-list pool has fewer than batch_size_eval="
                f"{cfg.batch_size_eval} entries: no full batch can be "
                f"formed; lower batch_size_eval or extend the lists")
        if args.batches is not None:
            n_batches = min(n_batches, args.batches)
    else:
        if args.mode == "separate" and cfg.max_mix != cfg.top_k:
            raise SystemExit(
                f"the sampler draws max_mix={cfg.max_mix} channels and the "
                f"top-k evaluator scores top_k={cfg.top_k} of them: set "
                f"max_mix to top_k (fewer live speakers per mixture through "
                f"min_mix); --mode recursive takes any count")
        bank, cfg, idx2spk = load_bank(cfg, args, device)
        data_speakers = cfg.num_speakers
        n_batches = args.batches if args.batches is not None else 4
    if ck_cfg is not None:
        # speaker ids past the trained embedding rows would be gathered out
        # of range
        if data_speakers > ck_cfg.num_speakers:
            raise SystemExit(
                f"the eval data references {data_speakers} speakers but the "
                f"checkpoint was trained with {ck_cfg.num_speakers}; use the "
                f"training data / vocabulary or a matching checkpoint")
        cfg = cfg.replace(num_speakers=ck_cfg.num_speakers)
    state = restore_for_eval(cfg, args, device)
    model = state.model
    ev = (make_recursive_eval_step(cfg) if args.mode == "recursive"
          else make_eval_step(cfg))
    noise_bank = (load_noise_bank(args.noise_wavs, cfg, device)
                  if args.noise_wavs else None)

    all_sisdr, all_sdr, all_oracle = [], [], []
    hits = hit_total = 0
    generator = torch.Generator().manual_seed(args.seed + 1)
    for b in range(n_batches):
        if list_batches is not None:
            batch = next(list_batches)
        else:
            batch = sample_mixtures(generator, bank, cfg, train=False)
        if noise_bank is not None:
            batch = add_noise_to_mix(generator, batch, noise_bank, cfg)
        feats = featurize(batch, cfg)
        live = batch.gains > 0
        if args.oracle:
            all_oracle.append(oracle_mask_sisdr(
                batch.mix_wav, batch.source_wavs, cfg, kind=args.oracle,
                live=live).cpu().numpy())
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
            h, n = _hits(batch.spk_idx, live, chosen)
            hits, hit_total = hits + h, hit_total + n
        all_sisdr.append(out["si_sdr"].float().cpu().numpy())
        if args.bss_eval:
            k_ref = feats["source_wavs"].shape[1]
            if out["pred_wavs"].shape[1] != k_ref:
                raise SystemExit(
                    f"--bss-eval needs square channel counts; recursive "
                    f"ran {out['pred_wavs'].shape[1]} peel steps against "
                    f"{k_ref} reference channels: set recursive_max_steps="
                    f"{k_ref} (or score an exported directory with "
                    f"run.score --pad-silent)")
            res = bss_eval_sources(feats["source_wavs"].float(),
                                   out["pred_wavs"].float(), flen=512)
            # dead (zero-gain) channels score ~-120 dB against a silent
            # reference: keep the live ones, gathered through the chosen
            # permutation (sdr[j] scores estimate j against source perm[j])
            live_perm = torch.gather(live, 1, res.perm)
            all_sdr.append(res.sdr[live_perm].cpu().numpy())
        if args.export_wavs:
            # every batch lands in one directory (the index offset by the
            # batch), so run.score over it reproduces the per-epoch
            # bss_test.cal protocol (main_run_multi_selfSS_recu.py:408-409)
            names = [[idx2spk[s] for s in row]
                     for row in batch.spk_idx.tolist()]
            # recursive pre-wavs are peel steps: each is named by the
            # speaker the loop extracted
            pred_names = ([[idx2spk[s] for s in row]
                           for row in out["spk_steps"].tolist()]
                          if args.mode == "recursive" else None)
            n = export_batch_outputs(
                args.export_wavs, batch.mix_wav.cpu().numpy(),
                out["pred_wavs"].float().cpu().numpy(), None, names,
                cfg.frame_rate, clean=(b == 0),
                real_wavs=batch.source_wavs.cpu().numpy(),
                idx_offset=b * batch.mix_wav.shape[0],
                live=live.cpu().numpy(), pred_names=pred_names)
            if b == n_batches - 1:
                print(f"exported wavs for {n_batches} batches to "
                      f"{args.export_wavs}/ (score with python -m "
                      f"dl4ss_tpu_torch.run.score {args.export_wavs})")

    sisdr = float(np.mean(np.concatenate(all_sisdr)))
    print(f"SI-SDR over {n_batches} batches: {sisdr:.2f} dB")
    if all_oracle:
        ob = float(np.mean(np.concatenate(all_oracle)))
        print(f"oracle {args.oracle.upper()} bound: {ob:.2f} dB "
              f"(gap {ob - sisdr:.2f} dB)")
    if hit_total:
        print(f"speaker hit rate: {hits}/{hit_total} "
              f"({100.0 * hits / hit_total:.1f}%)")
    if all_sdr:
        print(f"BSS-Eval SDR: {float(np.mean(np.concatenate(all_sdr))):.4f} "
              f"dB over {sum(len(x) for x in all_sdr)} channels")
    return sisdr


if __name__ == "__main__":
    main()
